"""Nova's decider on a chain's final state, in plain Python integers.

A chain after i steps is correct when (nova/src/proof.rs, and the commitment
openings a decider adds):

1. i is the number of steps taken, and z_i = F^i(z_0) on both curves for the
   step function F(z) = z^3 + z + 5 (over Fr on the primary, Fq on the
   secondary side);
2. the secondary's fresh instance carries the hashes of (i, z_0, z_i) and
   the running instance of the other side (MiMC, as the circuits compute);
3. the running instances satisfy the relaxed relation
   (A z) o (B z) = u (C z) + E, z = (u, x, W), and the secondary's fresh
   instance the strict one, row by row, over matrices that this module
   synthesizes itself (`nova_circuit`);
4. every commitment opens: comm_W = sum W_j g_j and comm_E = sum E_j g_j.
   The key points are g_j = k_j G for scalars k_j drawn from the seed
   (`key_scalars`), so an opening is one scalar multiplication of
   sum W_j k_j.

`state` is the program's final proof as plain values (`plain_state` in the
driver): ints, lists of ints, and points as (x, y, infinity) triples.
"""

from __future__ import annotations

from .ec import G1, GRUMPKIN, Q, R
from .nova_circuit.nova.augmented import AugmentedFCircuit
from .nova_circuit.nova.function import ExampleFunction
from .nova_circuit.nova.relaxed_r1cs import RelaxedR1csInstance
from .nova_circuit.pyref import AffinePoint
from .nova_circuit.r1cs import BN254_DRIVER, GRUMPKIN_DRIVER, R1CS


def example_chain(z0: int, steps: int, p: int) -> int:
    z = z0 % p
    for _ in range(steps):
        z = (z * z * z + z + 5) % p
    return z


def key_length(m: int) -> int:
    """A Pedersen key of 2^ceil(log2 m) + 1 points for an m-constraint shape."""
    return (1 << max((m - 1).bit_length(), 1)) + 1


class Shape:
    """A synthesized augmented circuit: rows of (column, coefficient) per
    matrix over z = (u, x_1 ... x_l, W)."""

    def __init__(self, cs):
        self.p, self.m, self.l, self.n_w = cs.p, cs.m, cs.l() - 1, cs.m_l_1()
        col = lambda kind, k: k if kind == "x" else k + self.l + 1
        self.rows = [[[(col(*wire), c) for wire, c in lc.terms.items()] for lc in mat]
                     for mat in (cs.a, cs.b, cs.c)]

    def unsatisfied_rows(self, u: int, x: list, w: list, e: list | None) -> int:
        """Rows where (A z)(B z) != u (C z) + E (E = 0 for the strict relation)."""
        if len(x) != self.l or len(w) != self.n_w or (e is not None and len(e) != self.m):
            return self.m
        p = self.p
        z = [u % p] + [v % p for v in x] + [v % p for v in w]
        a_rows, b_rows, c_rows = self.rows
        bad = 0
        for i in range(self.m):
            az = sum(c * z[k] for k, c in a_rows[i])
            bz = sum(c * z[k] for k, c in b_rows[i])
            cz = sum(c * z[k] for k, c in c_rows[i])
            if (az * bz - u * cz - (e[i] if e is not None else 0)) % p:
                bad += 1
        return bad


def synthesize():
    """The primary (over Fr) and secondary (over Fq) augmented circuits' shapes."""
    cs1 = R1CS(BN254_DRIVER)
    AugmentedFCircuit(other_driver=GRUMPKIN_DRIVER, fc=ExampleFunction, is_primary=True).generate(cs1)
    cs2 = R1CS(GRUMPKIN_DRIVER)
    AugmentedFCircuit(other_driver=BN254_DRIVER, fc=ExampleFunction, is_primary=False).generate(cs2)
    return Shape(cs1), Shape(cs2)


def key_scalars(rng, m_primary: int, m_secondary: int):
    """The discrete logs of both keys' points, drawn from `rng` in the order
    the public parameters sample them: the primary's (G1, below R), then the
    secondary's (Grumpkin, below Q)."""
    k1 = [rng.randrange(1, R) for _ in range(key_length(m_primary))]
    k2 = [rng.randrange(1, Q) for _ in range(key_length(m_secondary))]
    return k1, k2


def commit(curve, dlogs: list, msg: list, bits: int | None = None):
    """sum msg_j g_j for g_j = dlogs_j G, as an affine tuple (None: identity);
    `bits` keeps only each message entry's low bits (the control)."""
    if bits is not None:
        mask = (1 << bits) - 1
        msg = [v & mask for v in msg]
    return curve.mul(sum(a * b for a, b in zip(msg, dlogs)) % curve.order)


def _point(spec, pt):
    x, y, inf = pt
    return AffinePoint(spec, spec.field(x), spec.field(y), inf)


def _instance(driver, inst):
    spec = driver.commit_curve
    return RelaxedR1csInstance(driver=driver, commit_w=_point(spec, inst["commit_w"]),
                               commit_e=_point(spec, inst["commit_e"]), u=inst["u"], x=list(inst["x"]))


def _same(point, expected) -> bool:
    x, y, inf = point
    if expected is None or inf:
        return expected is None and inf
    return (x, y) == expected


class Decider:
    def __init__(self):
        self.primary, self.secondary = synthesize()

    def key_scalars(self, rng):
        return key_scalars(rng, self.primary.m, self.secondary.m)

    def check(self, state: dict, steps: int, keys) -> dict:
        """Counts of what fails, by the numbered items above: "state",
        "hash", "unsat_rows", "commits"."""
        k1, k2 = keys
        i = state["i"]
        bad_state = int(i != steps)
        bad_state += int(state["zi_primary"] != [example_chain(z, i, R) for z in state["z0_primary"]])
        bad_state += int(state["zi_secondary"] != [example_chain(z, i, Q) for z in state["z0_secondary"]])

        U1, W1 = state["u_range_primary"], state["w_range_primary"]
        U2, W2 = state["u_range_secondary"], state["w_range_secondary"]
        u2, w2 = state["u_single_secondary"], state["w_single_secondary"]
        bad_hash = 0
        if len(u2["x"]) != 2 or len(U1["x"]) != 2 or len(U2["x"]) != 2:
            bad_hash = 2
        else:
            h1 = _instance(GRUMPKIN_DRIVER, U2).hash(i, state["z0_primary"], state["zi_primary"])
            h2 = _instance(BN254_DRIVER, U1).hash(i, state["z0_secondary"], state["zi_secondary"])
            bad_hash += int(h1 != u2["x"][0])
            bad_hash += int(h2 != u2["x"][1] % GRUMPKIN_DRIVER.base.p)

        unsat = (self.primary.unsatisfied_rows(U1["u"], U1["x"], W1["w"], W1["e"])
                 + self.secondary.unsatisfied_rows(U2["u"], U2["x"], W2["w"], W2["e"])
                 + self.secondary.unsatisfied_rows(1, u2["x"], w2, None))

        openings = [
            (U1["commit_w"], commit(G1, k1, W1["w"])),
            (U1["commit_e"], commit(G1, k1, W1["e"])),
            (U2["commit_w"], commit(GRUMPKIN, k2, W2["w"])),
            (U2["commit_e"], commit(GRUMPKIN, k2, W2["e"])),
            (u2["commit_w"], commit(GRUMPKIN, k2, w2)),
        ]
        bad_commits = sum(not _same(pt, exp) for pt, exp in openings)
        return {"state": bad_state, "hash": bad_hash, "unsat_rows": unsat, "commits": bad_commits}
