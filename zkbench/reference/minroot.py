"""The MinRoot chain (Khovratovich, Maller and Tiwari, ePrint 2022/1626) as
microsoft/Nova's examples/minroot.rs proves it, in plain Python integers:
the map forward and backward, its step circuit over the frozen
`nova_circuit` gadgets, and the decider of a chain of such steps.

One round maps (x, y) to ((x + y)^(1/5), x); a step is `iterations` rounds
on the primary curve (over Fr), and the secondary's step is the identity
(Nova's `TrivialCircuit`). Fifth roots exist and are unique on Fr and Fq
(gcd(5, p - 1) = 1), so the map is a bijection and can be walked backward
with fifth powers alone: x_k = y_{k+1}, y_k = x_{k+1}^5 - y_{k+1}.

The decider judges a chain after i steps as `reference/nova.py` does, with
its `Shape`, `commit`, `key_scalars` and instance helpers, and with
z_i = F^(iterations i)(z_0) checked backward on the primary and z_i = z_0 on
the secondary.
"""

from __future__ import annotations

from . import nova
from .ec import G1, GRUMPKIN, R
from .nova_circuit.nova.augmented import AugmentedFCircuit
from .nova_circuit.r1cs import BN254_DRIVER, GRUMPKIN_DRIVER, R1CS, FieldAssignment as FA


def forward(z: tuple, rounds: int, p: int = R) -> tuple:
    """(x, y) after `rounds` rounds, by fifth roots (powers by 5^-1 mod p - 1)."""
    e = pow(5, -1, p - 1)
    x, y = z[0] % p, z[1] % p
    for _ in range(rounds):
        x, y = pow((x + y) % p, e, p), x
    return x, y


def backward(z: tuple, rounds: int, p: int = R) -> tuple:
    """(x, y) `rounds` rounds before z, by fifth powers."""
    x, y = z[0] % p, z[1] % p
    for _ in range(rounds):
        x2 = x * x % p
        x, y = y, (x2 * x2 % p * x - y) % p
    return x, y


def chain_backward(end: tuple, iterations: int, steps: int, p: int = R):
    """(z_0, hints) of a chain of `steps` steps that ends at `end`, made
    backward: hints[s] lists step s's x_{k+1}, one a round, in order."""
    x, y = end[0] % p, end[1] % p
    hints = []
    for _ in range(steps):
        step = [0] * iterations
        for k in range(iterations - 1, -1, -1):
            step[k] = x
            x2 = x * x % p
            x, y = y, (x2 * x2 % p * x - y) % p
        hints.append(step)
    hints.reverse()
    return (x, y), hints


class MinRootStep:
    """The step circuit of minroot.rs: a round allocates its hint x_{k+1},
    squares it twice, and enforces quad * x_{k+1} = x_k + y_k; y_{k+1} = x_k
    costs nothing. `hints` None: zeros (the shape)."""

    def __init__(self, iterations: int, hints: list | None = None):
        self.iterations, self.hints = iterations, hints

    def invoke_cs(self, cs, z_i):
        x, y = z_i
        for hint in self.hints if self.hints is not None else [0] * self.iterations:
            x1 = FA.witness(cs, hint)
            sq = FA.mul(cs, x1, x1)
            quad = FA.mul(cs, sq, sq)
            cs.mul_gate(quad.lc, x1.lc, (x + y).lc)
            x, y = x1, x
        return [x, y]


class TrivialStep:
    """z -> z (Nova's `TrivialCircuit`)."""

    @staticmethod
    def invoke_cs(cs, z_i):
        return list(z_i)


def synthesize(iterations: int):
    """The primary (MinRoot, over Fr) and secondary (trivial, over Fq)
    augmented circuits' shapes, on zero states of their arities."""
    cs1 = R1CS(BN254_DRIVER)
    AugmentedFCircuit(other_driver=GRUMPKIN_DRIVER, fc=MinRootStep(iterations), is_primary=True,
                      z_0=[0, 0]).generate(cs1)
    cs2 = R1CS(GRUMPKIN_DRIVER)
    AugmentedFCircuit(other_driver=BN254_DRIVER, fc=TrivialStep, is_primary=False, z_0=[0]).generate(cs2)
    return nova.Shape(cs1), nova.Shape(cs2)


class Decider(nova.Decider):
    """nova.Decider for a MinRoot chain of `iterations` rounds a step."""

    def __init__(self, iterations: int):
        self.iterations = iterations
        self.primary, self.secondary = synthesize(iterations)

    def check(self, state: dict, steps: int, keys) -> dict:
        """Counts of what fails: "state", "hash", "unsat_rows", "commits"."""
        k1, k2 = keys
        i = state["i"]
        z0, zi = state["z0_primary"], state["zi_primary"]
        bad_state = int(i != steps)
        bad_state += int(len(z0) != 2 or len(zi) != 2
                         or backward(zi, self.iterations * i) != (z0[0] % R, z0[1] % R))
        bad_state += int(state["zi_secondary"] != state["z0_secondary"])

        U1, W1 = state["u_range_primary"], state["w_range_primary"]
        U2, W2 = state["u_range_secondary"], state["w_range_secondary"]
        u2, w2 = state["u_single_secondary"], state["w_single_secondary"]
        bad_hash = 0
        if len(u2["x"]) != 2 or len(U1["x"]) != 2 or len(U2["x"]) != 2:
            bad_hash = 2
        else:
            h1 = nova._instance(GRUMPKIN_DRIVER, U2).hash(i, z0, zi)
            h2 = nova._instance(BN254_DRIVER, U1).hash(i, state["z0_secondary"], state["zi_secondary"])
            bad_hash += int(h1 != u2["x"][0])
            bad_hash += int(h2 != u2["x"][1] % GRUMPKIN_DRIVER.base.p)

        unsat = (self.primary.unsatisfied_rows(U1["u"], U1["x"], W1["w"], W1["e"])
                 + self.secondary.unsatisfied_rows(U2["u"], U2["x"], W2["w"], W2["e"])
                 + self.secondary.unsatisfied_rows(1, u2["x"], w2, None))

        openings = [
            (U1["commit_w"], nova.commit(G1, k1, W1["w"])),
            (U1["commit_e"], nova.commit(G1, k1, W1["e"])),
            (U2["commit_w"], nova.commit(GRUMPKIN, k2, W2["w"])),
            (U2["commit_e"], nova.commit(GRUMPKIN, k2, W2["e"])),
            (u2["commit_w"], nova.commit(GRUMPKIN, k2, w2)),
        ]
        bad_commits = sum(not nova._same(pt, exp) for pt, exp in openings)
        return {"state": bad_state, "hash": bad_hash, "unsat_rows": unsat, "commits": bad_commits}
