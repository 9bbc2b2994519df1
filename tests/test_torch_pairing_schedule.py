"""The schedules P1, P2 and P3's schedule route run on the card
(`ops/pairing_schedule.py`), evaluated here from the exact int32 table the
card reads, on Python integers mod q: each level (P1's square and line; P2's
square, multiply, a set bit's multiply and square, and the easy part's
levels through the whole program) against the port's pyref tower (`Fq12`
multiply, square, `mul_by_034`) and the plain versions (`f12_*_h`), on
seeded values with edge components (0, 1, q - 1); the whole programs
against the host's `multi_miller_loop` and `final_exp_fast`, the port's and
the JAX package's, values passed between the packages as ints; each of P3's
one-op schedules against P3's plain version, which
test_torch_pairing_tower.py holds to the JAX package's tower ops on the same
values; the level and multiply counts the depth floor and the bound use; and
what the kernel relies on, read back from the table. Exact."""

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
         self.out_slot, self.shared, self.prog_off, self.prog_len, self.zero, self.in2_slot,
         self.in2_len) = self.t[:S.HDR_WORDS]

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

    def initial_slots(self, inputs=None, inputs2=None):
        slots = [0] * self.n_slots
        for c in range(self.n_consts):
            row = self.t[self.const_off + 9 * c: self.const_off + 9 * c + 9]
            if row[0] < self.n_slots:
                slots[row[0]] = words_to_int(row[1:])
            else:  # a negation, written with its slot
                assert (slots[row[0] - self.n_slots] + words_to_int(row[1:])) % Q == 0
        if self.in_slot >= 0:
            slots[self.in_slot: self.in_slot + 12] = inputs
        if self.in2_slot >= 0:
            assert len(inputs2) == self.in2_len
            slots[self.in2_slot: self.in2_slot + self.in2_len] = inputs2
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

    def run(self, inputs=None, lines=(), inputs2=None):
        slots, r = self.initial_slots(inputs, inputs2), 0
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
    """What the kernel relies on, read back from each table (P1's, P2's and
    every one-op schedule of P3, frobenius at every power): a level's
    products read no product of that level and only slots (lines only in
    LINE levels); no output reads a slot another output writes; sums of |c|
    within the kernel's wide sum; the zero slot never written; the inputs
    within the slots; the shared part fits in shared memory; the table
    padded to whole 16-byte copies."""
    one_op = [S.f12_op(op, k) for op in S.F12_OPS for k in (range(12) if op == "frobenius" else (0,))]
    for sched in (S.miller_loop(1), S.miller_loop(3), S.miller_loop(64), S.final_exp(), *one_op):
        tab = Table(sched)
        assert tab.shared == tab.prog_off and sched.smem_bytes() <= 227 * 1024
        assert tab.zero == tab.n_slots - 1 and len(tab.t) % 4 == 0
        for first, count in ((tab.in_slot, 12), (tab.in2_slot, tab.in2_len)):
            assert first < 0 or 0 <= first and first + count <= tab.zero
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


# P3's one-op schedules (`S.f12_op`): each op, frobenius at powers 1, 2, 3, 6
ONE_OP = [("mul", 0), ("sq", 0), ("inv", 0), ("conj", 0), ("mul_by_034", 0),
          ("frobenius", 1), ("frobenius", 2), ("frobenius", 3), ("frobenius", 6)]


def one_op_values(power: int):
    """P3's one-op inputs at a frobenius power (0 for the other ops), as 12
    ints each: `values(20 + power, 3)` (seeded values with edge components,
    then zero, one and all q - 1), and each one's second operand, the next
    value; mul_by_034's line (c0, c3, c4) is that value's first six
    components."""
    xs = values(20 + power, 3)
    return xs, xs[1:] + xs[:1]


@pytest.mark.parametrize("op,power", ONE_OP, ids=[f"{op}{k if op == 'frobenius' else ''}" for op, k in ONE_OP])
def test_f12_op_schedule_matches_plain(op, power):
    """P3's schedule route: the one-op schedule's table, run here on Python
    integers, equals P3's plain version (`map_plain`, all lanes in one call)
    on `one_op_values`: seeded values with edge components, zero, one and
    all q - 1; mul's second operand is another value, mul_by_034's line
    (c0, c3, c4) another value's first six components.
    test_torch_pairing_tower.py holds the plain version to the JAX
    package's tower op on the same values."""
    tab = Table(S.f12_op(op, power))
    xs, ys = one_op_values(power)
    seconds = {"mul": ys, "mul_by_034": [y[:6] for y in ys]}.get(op, [None] * len(xs))
    got = [tab.run(x, inputs2=y) for x, y in zip(xs, seconds)]
    a = P.encode_fq12([fq12(x) for x in xs], "cpu")
    b = None
    if op == "mul":
        b = P.encode_fq12([fq12(y) for y in ys], "cpu")
    elif op == "mul_by_034":
        b = P.encode_fq12([fq12(y + [0] * 6) for y in seconds], "cpu")[:48].contiguous()
    assert got == [ints12(v) for v in P.decode_fq12(P.map_plain(op, a, b, power))]


def test_f12_op_depth_and_products():
    """P3's schedule route: `depth_levels("f12_map", op=...)` is each
    schedule's count (one level of products for mul, sq, mul_by_034 and
    frobenius at every power; inv's 7 and its Fermat inverse; conj's level
    of outputs makes no product), the depth floor counts them, and the
    schedules make the multiplies the bound counts (frobenius 15, its
    constants multiplied on the host; inv's besides its Fermat inverse)."""
    want = {"mul": (1, 0), "sq": (1, 0), "inv": (7, 1), "frobenius": (1, 0), "conj": (0, 0), "mul_by_034": (1, 0)}
    for op in S.F12_OPS:
        for k in range(12) if op == "frobenius" else (0,):
            sched = S.f12_op(op, k)
            assert P.depth_levels("f12_map", op=op, power=k) == sched.depth() == want[op], (op, k)
            assert len(sched.program) == max(1, sum(want[op]))
        levels, inverses = want[op]
        floor = P.depth_floor_ms("f12_map", 100.0, 300.0, 1e9, 0.002, op=op)
        assert abs(floor - ((levels * 100.0 + inverses * P._INV_FQ * 300.0) / 1e9 * 1e3 + 0.002)) < 1e-15
    for op in ("mul", "sq", "mul_by_034", "conj"):
        assert S.f12_op(op).products() == P.MULS[op]
    assert all(S.f12_op("frobenius", k).products() == P.MULS["frobenius"] == 15 for k in range(12))
    assert S.f12_op("inv").products() + P._INV_FQ == P.MULS["inv"]
    assert S.f12_op("frobenius", 15) is S.f12_op("frobenius", 3)
    with pytest.raises(ValueError, match="unknown op"):
        S.f12_op("div")


def test_p3_routes_cover_every_lane_count():
    """P3's rule gives a route for every op at every lane count from 1 to
    2^17: the schedule route at the one lane the verify equation's Gt check
    multiplies on (conj, which makes no product, on the thread route), the
    thread route from each op's threshold on and at 2^16 lanes; a route
    that does not exist raises before anything runs."""
    for op in P.OPS:
        routes = [P.p3_route(op, n) for n in range(1, (1 << 17) + 1)]
        assert set(routes) <= set(P.ROUTES)
        first = routes.index("thread")
        assert routes[first:] == ["thread"] * (len(routes) - first), op  # one switch, to the thread route
        assert P.p3_route(op, 1 << 16) == "thread"
        assert P.p3_route(op, 1) == ("thread" if op == "conj" else "schedule")
    a = P.encode_fq12([Fq12.one()], "cpu")
    with pytest.raises(ValueError, match="unknown route"):
        P.f12_map("sq", a, route="warp")
