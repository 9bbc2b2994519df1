"""The schedules P1 and P2 run on the card (`ops/pairing_schedule.py`),
evaluated here from the exact int32 table the card reads, on Python
integers mod q: each level (P1's square and line; P2's square, multiply, a
set bit's multiply and square, and the easy part's levels through the whole
program) against the port's pyref tower (`Fq12` multiply, square,
`mul_by_034`) and the plain versions (`f12_*_h`), on seeded values with edge
components (0, 1, q - 1); the whole programs against the host's
`multi_miller_loop` and `final_exp_fast`, the port's and the JAX
package's, values passed between the packages as ints; the level and
multiply counts the depth floor and the bound use; and what the kernel
relies on, read back from the table. Exact."""

import numpy as np
import pytest
import torch

from kogarashi_tpu import pyref as jpyref
from kogarashi_tpu.pyref import pairing_fast as jpf
from kogarashi_tpu_torch import constants as C
from kogarashi_tpu_torch import pyref
from kogarashi_tpu_torch.ops import pairing as P
from kogarashi_tpu_torch.ops import pairing_schedule as S
from kogarashi_tpu_torch.pyref import Fq, Fq12
from kogarashi_tpu_torch.pyref.pairing_fast import G2Prepared, final_exp_fast, multi_miller_loop
from kogarashi_tpu_torch.pyref.tower import Fq2
from torch_verify_equation import verify_equation_pairs

Q = C.Q
R_INV = pow(1 << 256, -1, Q)
EDGES = (0, 1, Q - 1)


def words_to_int(ws) -> int:
    """8 Montgomery words (int32) -> the standard value."""
    return sum((int(w) & 0xFFFFFFFF) << (32 * k) for k, w in enumerate(ws)) * R_INV % Q


class Table:
    """A schedule's int32 table, decoded as csrc/pairing.cu `run_schedule`
    reads it."""

    def __init__(self, sched):
        self.t = [int(x) for x in sched.table]
        (self.n_slots, self.n_levels, self.lev_off, self.n_consts, self.const_off, self.in_slot,
         self.out_slot, self.shared, self.prog_off, self.prog_len, self.zero) = self.t[:S.HDR_WORDS]

    def level(self, lid):
        return self.t[self.lev_off + 5 * lid: self.lev_off + 5 * lid + 5]

    def terms(self, off, n):
        """An entry's terms as (slot, signed coefficient): a slot in
        [n_slots, 2 n_slots) is the negation of slot - n_slots, and one from
        2 n_slots on a line slot, given as n_slots + l."""
        out = []
        for w in self.t[off: off + n]:
            slot, c = w & 0xFFFF, w >> 16
            assert c > 0
            if slot >= 2 * self.n_slots:
                out.append((slot - self.n_slots, c))
            elif slot >= self.n_slots:
                out.append((slot - self.n_slots, -c))
            else:
                out.append((slot, c))
        return out

    def products(self, lv):
        rows = [self.t[lv[2] + S.PROD_WORDS * k: lv[2] + S.PROD_WORDS * (k + 1)] for k in range(lv[1])]
        return [(r[0], self.terms(r[1], r[2]), self.terms(r[3], r[4])) for r in rows]

    def outputs(self, lv):
        rows = [self.t[lv[4] + S.OUT_WORDS * j: lv[4] + S.OUT_WORDS * (j + 1)] for j in range(lv[3])]
        return [(r[0], self.terms(r[1], r[2])) for r in rows]

    def program(self):
        return self.t[self.prog_off: self.prog_off + self.prog_len]

    def initial_slots(self, inputs=None):
        slots = [0] * self.n_slots
        for c in range(self.n_consts):
            row = self.t[self.const_off + 9 * c: self.const_off + 9 * c + 9]
            if row[0] < self.n_slots:
                slots[row[0]] = words_to_int(row[1:])
            else:  # a negation, written with its slot
                assert (slots[row[0] - self.n_slots] + words_to_int(row[1:])) % Q == 0
        if self.in_slot >= 0:
            slots[self.in_slot: self.in_slot + 12] = inputs
        return slots

    def run_level(self, lid, slots, line=()):
        """One level on `slots` in place; `line`: the current record's 6 ints."""
        lv = self.level(lid)
        if lv[0] == S.INVERSE:
            slots[lv[2]] = pow(slots[lv[1]], Q - 2, Q)
            return

        def val(s):
            return slots[s] if s < self.n_slots else line[s - self.n_slots]

        for dst, a, b in self.products(lv):
            slots[dst] = sum(c * val(s) for s, c in a) * sum(c * val(s) for s, c in b) % Q
        for dst, terms in self.outputs(lv):
            slots[dst] = sum(c * slots[s] for s, c in terms) % Q

    def run(self, inputs=None, lines=()):
        slots, r = self.initial_slots(inputs), 0
        for lid in self.program():
            line = ()
            if self.level(lid)[0] == S.LINE:
                line, r = lines[r], r + 1
            self.run_level(lid, slots, line)
        assert r == len(lines)
        return slots[self.out_slot: self.out_slot + 12]


def ints12(x: Fq12) -> list:
    return [v.v for v in x.to_fq_list()]


def fq12(vals) -> Fq12:
    return Fq12.from_fq_list([Fq(v) for v in vals])


def jax_final_exp(vals) -> list:
    """The JAX package's final_exp_fast on 12 ints, back as 12 ints."""
    return ints12(jpf.final_exp_fast(jpyref.Fq12.from_fq_list([jpyref.Fq(v) for v in vals])))


def values(seed: int, n: int) -> list:
    """n Fq12s as 12 ints each: seeded random ones with components set to 0,
    1 and q - 1 among them, then zero, one and all q - 1."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        vals = [int.from_bytes(rng.bytes(32), "little") % Q for _ in range(12)]
        for k in rng.choice(12, size=i % 5, replace=False):
            vals[k] = EDGES[int(k) % 3]
        out.append(vals)
    return out + [[0] * 12, ints12(Fq12.one()), [Q - 1] * 12]


def plain(fn, *xs):
    """A plain tower op (`f12_*_h`) on pyref Fq12s, back as 12 ints."""
    hs = [P._h(P.encode_fq12(x, "cpu")) for x in xs]
    return ints12(P.decode_fq12(P._w(fn(*hs))))


def test_level_counts():
    """The levels the depth floor counts: 63 squares + 91 lines per pair
    for P1 (336 at the verify equation's 3 pairs), and P2's easy part (10
    levels and one Fermat inverse) plus one level per hard-part bit. The Fq
    multiplies the bound counts, from the schedules: P1's are the one-thread
    code's; P2's are its formulas' (the inverse, two Fq12 products, the
    Frobenius map's five Fq2 products by the host's constants, then a square
    per hard-part bit but the last and a product per set bit)."""
    for n in (1, 2, 3, 5):
        sched = S.miller_loop(n)
        assert sched.depth() == (63 + 91 * n, 0) and sched.n_lines() == 91 * n
        assert sched.products() == P.kernel_muls("pair_miller_loop", n)
    assert S.miller_loop(3).depth() == (336, 0)
    fe = S.final_exp()
    assert len(S.HARD_BITS) == 761
    assert fe.depth() == (10 + 761, 1)
    assert P.depth_levels("pair_final_exp") == (771, 1)
    assert P.depth_levels("pair_miller_loop", 3) == (336, 0)
    for n in (1, 3):
        assert P.schedule_muls("pair_miller_loop", n) == P.kernel_muls("pair_miller_loop", n)
    easy = P.MULS["inv"] + 2 * P.MULS["mul"] + 5 * 3
    hard = (len(S.HARD_BITS) - 1) * P.MULS["sq"] + sum(S.HARD_BITS) * P.MULS["mul"]
    assert P.schedule_muls("pair_final_exp") == fe.products() + P._INV_FQ == easy + hard


def test_table_invariants():
    """What the kernel relies on, read back from each table: a level's
    products read no product of that level and only slots (lines only in
    LINE levels); no output reads a slot another output writes; sums of |c|
    within the kernel's wide sum; the zero slot never written; the shared
    part fits in shared memory."""
    for sched in (S.miller_loop(1), S.miller_loop(3), S.miller_loop(64), S.final_exp()):
        tab = Table(sched)
        assert tab.shared == tab.prog_off and sched.smem_bytes() <= 227 * 1024
        assert tab.zero == tab.n_slots - 1
        for lid in range(tab.n_levels):
            lv = tab.level(lid)
            if lv[0] == S.INVERSE:
                assert all(0 <= s < tab.n_slots for s in lv[1:3])
                continue
            prods, outs = tab.products(lv), tab.outputs(lv)
            pdst = {d for d, _, _ in prods}
            top = tab.n_slots + (6 if lv[0] == S.LINE else 0)
            for _, a, b in prods:
                for terms in (a, b):
                    assert terms and not {s for s, _ in terms} & pdst
                    assert all(0 <= s < top for s, _ in terms)
                    assert sum(abs(c) for _, c in terms) <= S.MAX_COEFF_SUM
            odst = [d for d, _ in outs]
            assert len(set(odst)) == len(odst) and tab.zero not in odst and tab.zero not in pdst
            for j, (_, terms) in enumerate(outs):
                assert not {s for s, _ in terms} & (set(odst) - {odst[j]})
                assert all(0 <= s < tab.n_slots for s, _ in terms)
                assert sum(abs(c) for _, c in terms) <= S.MAX_COEFF_SUM


@pytest.mark.parametrize("op", ["sq", "mul", "mul_sq", "mul_sq_same"])
def test_final_exp_level_matches_tower(op):
    """P2's hard-part levels on R and T: T = T^2, R = R T, and a set bit's
    R = R T with T = T^2 in one level (also with R = T), against pyref and
    the plain versions."""
    tab = Table(S.final_exp())
    lid = {"sq": S.FE_SQ, "mul": S.FE_MUL, "mul_sq": S.FE_MULSQ, "mul_sq_same": S.FE_MULSQ}[op]
    xs = values(11, 6)
    for r_vals, t_vals in zip(xs, xs[1:] + xs[:1]):
        if op == "mul_sq_same":
            r_vals = t_vals
        slots = tab.initial_slots([0] * 12)
        slots[S.FE_R: S.FE_R + 12], slots[S.FE_T: S.FE_T + 12] = r_vals, t_vals
        tab.run_level(lid, slots)
        r, t = fq12(r_vals), fq12(t_vals)
        want_r = ints12(r * t) if op != "sq" else r_vals
        want_t = ints12(t.square()) if op != "mul" else t_vals
        assert slots[S.FE_R: S.FE_R + 12] == want_r
        assert slots[S.FE_T: S.FE_T + 12] == want_t
        if op != "sq":
            assert want_r == plain(P.f12_mul_h, r, t)
        if op != "mul":
            assert want_t == plain(P.f12_sq_h, t)


@pytest.mark.parametrize("op", ["sq", "line"])
def test_miller_loop_level_matches_tower(op):
    """P1's levels on the accumulator: its square, and the line multiply
    with the current record's (c0, c3, c4), against pyref and the plain
    versions."""
    tab = Table(S.miller_loop(2))
    xs = values(12, 6)
    for a_vals, l_vals in zip(xs, xs[::-1]):
        line = l_vals[:6]
        slots = tab.initial_slots()
        slots[S.ML_ACC: S.ML_ACC + 12] = a_vals
        tab.run_level(S.ML_SQ if op == "sq" else S.ML_LINE, slots, line)
        a = fq12(a_vals)
        c0, c3, c4 = (Fq2(Fq(line[2 * k]), Fq(line[2 * k + 1])) for k in range(3))
        if op == "sq":
            want = ints12(a.square())
            assert want == plain(P.f12_sq_h, a)
        else:
            want = ints12(a.mul_by_034(c0, c3, c4))
            b = P.encode_fq12(fq12(line + [0] * 6), "cpu")[:48, None]  # c0, c3, c4: 48 words
            assert want == ints12(P.decode_fq12(P.map_plain("mul_by_034", P.encode_fq12([a], "cpu"), b))[0])
        assert slots[S.ML_ACC: S.ML_ACC + 12] == want


def _line_records(pairs) -> list:
    """The line records P1 reads, in its order, as 6 ints each."""
    w = P._encode_prepared(pairs, "cpu").numpy().reshape(-1, 6, 8)
    return [[words_to_int(rec[k]) for k in range(6)] for rec in w]


@pytest.mark.parametrize("n_pairs", [1, 2, 3])
def test_miller_loop_program_matches_host(n_pairs):
    """P1's whole program over n_pairs' line records (as `_encode_prepared`
    lays them out) equals the host's multi_miller_loop, the port's and the
    JAX package's on the same pairs."""
    ks = [(3, 5), (7, 11), (13, 17)][:n_pairs]
    g1, g2 = pyref.G1_SPEC.generator, pyref.G2_SPEC.generator
    jg1, jg2 = jpyref.G1_SPEC.generator, jpyref.G2_SPEC.generator
    pairs = [(a * g1, G2Prepared.from_affine(b * g2)) for a, b in ks]
    jpairs = [(a * jg1, jpf.G2Prepared.from_affine(b * jg2)) for a, b in ks]
    got = Table(S.miller_loop(n_pairs)).run(lines=_line_records(pairs))
    assert got == ints12(multi_miller_loop(pairs)) == ints12(jpf.multi_miller_loop(jpairs))


def test_final_exp_program_matches_host():
    """P2's whole program: the verify equation's Miller value goes to the
    key's alpha_g1_beta_g2; one to one; zero to zero (fp_inv maps 0 to 0,
    as the plain version does); a seeded Fq12 outside Gt to final_exp_fast's
    value. Each but zero (whose inverse the JAX package's pyref leaves
    undefined) also equals the JAX package's final_exp_fast."""
    tab = Table(S.final_exp())
    pairs, pvk = verify_equation_pairs()
    ml = multi_miller_loop(pairs)
    assert tab.run(ints12(ml)) == ints12(final_exp_fast(ml)) == ints12(pvk.alpha_g1_beta_g2)
    assert tab.run(ints12(Fq12.one())) == ints12(Fq12.one())
    assert tab.run([0] * 12) == [0] * 12
    x = fq12(values(13, 1)[0])
    fe = final_exp_fast(x)
    assert fe * fe.conjugate() == Fq12.one() and x * x.conjugate() != Fq12.one()
    assert tab.run(ints12(x)) == ints12(fe)
    for vals in (ints12(ml), ints12(Fq12.one()), ints12(x)):
        assert tab.run(vals) == jax_final_exp(vals)


def test_wrappers_refuse_wrong_shapes():
    """P1's and P2's wrappers check the shape before they dispatch, so the
    kernel never reads past a tensor: a wrong one raises, and nothing is
    launched or computed."""
    coeffs = P._encode_prepared(verify_equation_pairs()[0], "cpu")
    f = P.encode_fq12(Fq12.one(), "cpu")
    before = dict(P.LAUNCHES)
    for bad in (coeffs[:90], coeffs[:, :0], coeffs[..., :15], coeffs[0]):
        with pytest.raises(ValueError, match="expected"):
            P.miller_loop_coeffs(bad)
    for bad in (f[:95], f[:, None], torch.zeros(97, dtype=torch.int32)):
        with pytest.raises(ValueError, match="expected"):
            P.final_exp_device(bad)
    assert P.LAUNCHES == before
