"""The schedules that P1 (`pair_miller_loop`), P2 (`pair_final_exp`) and P3's
schedule route (`f12_op`: one tower op, a block a lane) run on a block of
threads (csrc/pairing.cu `run_schedule`): each Fq12 tower op as one level of
independent Fq products and the sums around them, as data.

A level is N products m_k = A_k * B_k, each operand a signed sum of Fq
slots (sum of c_i x_i with small integers c_i: the Karatsuba pre-additions,
the multiplies by xi = 9 + u and by v, conjugation), made one a thread; a
barrier; then M outputs, each a signed sum of the products (and of slots),
written to slots, each by a group of lanes; a barrier. The formulas are csrc/pairing.cu's
one-thread ones, which are the JAX package's (kogarashi_tpu/ops/pairing.py
:124-222): the Karatsuba Fq6 and Fq12 multiplies (18 and 54 products), the
Fq12 square on two Fq6 multiplies (36), the sparse line multiply (39), the
inverse down the tower to one Fermat inverse in Fq, which one thread runs
(an "inverse" level) while the others wait. Every value the kernel keeps is
canonical, so the order of the sums changes no word of the result.

The table the card reads (int32, `Schedule.table`):
  header (HDR_WORDS): n_slots, n_levels, levels' offset, n_consts, consts'
    offset, input slot (-1: none; 12 Fq from there), output slot, words
    copied to shared memory, program offset, program length, the zero slot,
    the second input's slot (-1: none) and its count of Fq (P3's mul: the
    second Fq12, 12; mul_by_034: the line's c0, c3, c4, 6)
  per level 5 ints: kind (LEVEL, INVERSE, LINE), then for LEVEL and LINE
    n_prod, products' offset, n_out, outputs' offset; for INVERSE the source
    and destination slots
  per product 5 ints: destination slot, A's terms' offset and count, B's
  per output 3 ints: destination slot, terms' offset and count
  terms: slot | coefficient << 16, the coefficient positive: a negative
    coefficient -c on slot s is c on s's negation, slot n_slots + s
  per constant 9 ints: slot, 8 Montgomery words (the negations' too)
  program: level ids, in order (read from device memory, not copied)
  zeros to a multiple of 4 words (the kernel copies 16 bytes at a time)
Slots 0..n_slots-1 live in shared memory, 8 words each, and slot n_slots +
s holds q - (slot s), written with it, so a sum is only additions; the last
slot is the zero slot, never written, which pads a chunk of terms. A LINE
level reads the current line record (c0, c3, c4: 6 Fq) as slots 2 n_slots
.. 2 n_slots + 5, with positive coefficients only, and moves to the next
record after it.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from ..fields.spec import FQ
from ..pyref.pairing_fast import HARD_PART_EXP, SIX_U_PLUS_2_NAF
from ..pyref.tower import FROB_FQ6_C1, FROB_FQ6_C2, FROB_FQ12_C1

LEVEL, INVERSE, LINE = 0, 1, 2
HDR_WORDS = 13
PROD_WORDS, OUT_WORDS = 5, 3
LINE_WORDS = 48  # one line record: c0, c3, c4, 16 words each
LINE_CHUNK = 16  # records staged into shared memory at a time (csrc/pairing.cu kLineChunk)
MAX_COEFF_SUM = 1 << 14  # sum of |c| of one entry: the kernel's wide sum stays below 2^14 q


class Lin:
    """A signed sum of slots, {slot: coefficient}."""

    __slots__ = ("t",)

    def __init__(self, t=None):
        self.t = {s: c for s, c in (t or {}).items() if c}

    @staticmethod
    def slot(s: int) -> "Lin":
        return Lin({s: 1})

    def __add__(self, o):
        t = dict(self.t)
        for s, c in o.t.items():
            t[s] = t.get(s, 0) + c
        return Lin(t)

    def __neg__(self):
        return Lin({s: -c for s, c in self.t.items()})

    def __sub__(self, o):
        return self + (-o)

    def __mul__(self, k: int):
        return Lin({s: c * k for s, c in self.t.items()})


class _Products:
    """The products of one level, made as the formulas ask for them."""

    def __init__(self, first_slot: int):
        self.first = first_slot
        self.ops: list = []

    def mul(self, a: Lin, b: Lin) -> Lin:
        self.ops.append((a, b))
        return Lin.slot(self.first + len(self.ops) - 1)


# The tower on Lin: an Fq2 is (c0, c1), an Fq6 (c0, c1, c2) of Fq2s, an Fq12
# (c0, c1) of Fq6s. Each function follows its namesake in csrc/pairing.cu.

def f2_add(a, b):
    return (a[0] + b[0], a[1] + b[1])


def f2_sub(a, b):
    return (a[0] - b[0], a[1] - b[1])


def f2_neg(a):
    return (-a[0], -a[1])


def f2_mul_xi(a):
    """* (9 + u): (9 a0 - a1, 9 a1 + a0)."""
    return (a[0] * 9 - a[1], a[1] * 9 + a[0])


def f2_mul(P, a, b):
    m0, m1 = P.mul(a[0], b[0]), P.mul(a[1], b[1])
    m2 = P.mul(a[0] + a[1], b[0] + b[1])
    return (m0 - m1, m2 - m0 - m1)


def f2_sq(P, a):
    m = P.mul(a[0], a[1])
    return (P.mul(a[0] + a[1], a[0] - a[1]), m + m)


def f6_add(a, b):
    return tuple(f2_add(x, y) for x, y in zip(a, b))


def f6_sub(a, b):
    return tuple(f2_sub(x, y) for x, y in zip(a, b))


def f6_neg(a):
    return tuple(f2_neg(x) for x in a)


def f6_mul_nonres(a):
    """* v: (xi c2, c0, c1)."""
    return (f2_mul_xi(a[2]), a[0], a[1])


def f6_mul(P, a, b):
    t0, t1, t2 = f2_mul(P, a[0], b[0]), f2_mul(P, a[1], b[1]), f2_mul(P, a[2], b[2])
    c0 = f2_add(t0, f2_mul_xi(f2_sub(f2_sub(f2_mul(P, f2_add(a[1], a[2]), f2_add(b[1], b[2])), t1), t2)))
    c1 = f2_add(f2_sub(f2_sub(f2_mul(P, f2_add(a[0], a[1]), f2_add(b[0], b[1])), t0), t1), f2_mul_xi(t2))
    c2 = f2_add(f2_sub(f2_sub(f2_mul(P, f2_add(a[0], a[2]), f2_add(b[0], b[2])), t0), t2), t1)
    return (c0, c1, c2)


def f6_mul_by_01(P, a, b0, b1):
    t0, t1 = f2_mul(P, a[0], b0), f2_mul(P, a[1], b1)
    c0 = f2_add(f2_mul_xi(f2_sub(f2_mul(P, f2_add(a[1], a[2]), b1), t1)), t0)
    c2 = f2_add(f2_sub(f2_mul(P, f2_add(a[0], a[2]), b0), t0), t1)
    c1 = f2_sub(f2_sub(f2_mul(P, f2_add(a[0], a[1]), f2_add(b0, b1)), t0), t1)
    return (c0, c1, c2)


def f12_conj(a):
    return (a[0], f6_neg(a[1]))


def f12_mul(P, a, b):
    t0, t1 = f6_mul(P, a[0], b[0]), f6_mul(P, a[1], b[1])
    s = f6_mul(P, f6_add(a[0], a[1]), f6_add(b[0], b[1]))
    return (f6_add(t0, f6_mul_nonres(t1)), f6_sub(f6_sub(s, t0), t1))


def f12_sq(P, a):
    t = f6_mul(P, a[0], a[1])
    s = f6_mul(P, f6_add(a[0], a[1]), f6_add(a[0], f6_mul_nonres(a[1])))
    return (f6_sub(f6_sub(s, t), f6_mul_nonres(t)), f6_add(t, t))


def f12_mul_by_034(P, a, c0, c3, c4):
    t0 = tuple(f2_mul(P, x, c0) for x in a[0])
    t1 = f6_mul_by_01(P, a[1], c3, c4)
    t2 = f6_mul_by_01(P, f6_add(a[0], a[1]), f2_add(c0, c3), c4)
    return (f6_add(f6_mul_nonres(t1), t0), f6_sub(f6_sub(t2, t0), t1))


def fq2_at(s: int):
    return (Lin.slot(s), Lin.slot(s + 1))


def fq6_at(s: int):
    return tuple(fq2_at(s + 2 * i) for i in range(3))


def fq12_at(s: int):
    """The Fq12 in slots s..s+11, in `Fq12.to_fq_list` order."""
    return (fq6_at(s), fq6_at(s + 6))


def flat(x) -> list:
    """An Fq2 / Fq6 / Fq12 of Lins -> its Lins in `to_fq_list` order."""
    if isinstance(x, Lin):
        return [x]
    return [v for c in x for v in flat(c)]


@dataclass
class Level:
    kind: int
    prods: list  # [(dst, A, B)]
    outs: list  # [(dst, Lin)]
    inv: tuple = ()  # INVERSE: (src, dst)


def _level(first_prod: int, make, dst: int, kind: int = LEVEL) -> Level:
    """make(P) -> the result (an Fq / Fq2 / Fq6 / Fq12 of Lins, or a list of
    them) written to consecutive slots from dst."""
    P = _Products(first_prod)
    outs = flat(make(P))
    return Level(kind, [(first_prod + k, a, b) for k, (a, b) in enumerate(P.ops)],
                 [(dst + j, o) for j, o in enumerate(outs)])


@dataclass
class Schedule:
    name: str
    n_slots: int
    levels: list  # Level by id
    program: list  # level ids
    consts: list  # [(slot, int value)]
    in_slot: int
    out_slot: int
    in2_slot: int = -1
    in2_len: int = 0

    def __post_init__(self):
        self.table = _encode(self)

    @property
    def zero_slot(self) -> int:
        return self.n_slots - 1

    @property
    def shared_words(self) -> int:
        return int(self.table[7])

    def depth(self) -> tuple:
        """(levels of products, inverse levels) the program runs in order; a
        level of outputs alone (P3's conj) makes no product."""
        inv = sum(self.levels[i].kind == INVERSE for i in self.program)
        return sum(bool(self.levels[i].prods) for i in self.program), inv

    def n_lines(self) -> int:
        return sum(self.levels[i].kind == LINE for i in self.program)

    def smem_bytes(self) -> int:
        """Dynamic shared memory of a launch: the table, the slots, and two
        chunks of line records where the program reads lines."""
        lines = 2 * LINE_CHUNK * LINE_WORDS * 4 if self.n_lines() else 0
        return 4 * ((self.shared_words + 3) & ~3) + 2 * 32 * self.n_slots + lines

    def products(self) -> int:
        """Fq products the program makes (the inverse's counted apart)."""
        return sum(len(self.levels[i].prods) for i in self.program)


def _check(s: Schedule) -> None:
    """What the kernel relies on: products read no product slot of their
    level; no output reads a slot another output of its level writes; every
    slot read exists; the wide sums stay in bounds."""
    for lv in s.levels:
        if lv.kind == INVERSE:
            continue
        prod_slots = {d for d, _, _ in lv.prods}
        line_slots = set(range(s.n_slots, s.n_slots + 6)) if lv.kind == LINE else set()
        dsts = [d for d, _ in lv.outs]
        assert len(set(dsts)) == len(dsts)
        assert all(0 <= d < s.zero_slot for d in dsts + sorted(prod_slots))
        for _, a, b in lv.prods:
            for x in (a, b):
                assert not (set(x.t) & prod_slots), "a product reads a product of its own level"
                assert all(0 <= k < s.n_slots or (k in line_slots and x.t[k] > 0) for k in x.t)
        for j, (d, o) in enumerate(lv.outs):
            others = set(dsts[:j] + dsts[j + 1:])
            assert not (set(o.t) & others), "an output reads a slot another output writes"
            assert all(0 <= k < s.n_slots for k in o.t)
        for x in [a for _, a, _ in lv.prods] + [b for _, _, b in lv.prods] + [o for _, o in lv.outs]:
            assert x.t and sum(abs(c) for c in x.t.values()) <= MAX_COEFF_SUM
            assert all(abs(c) < 1 << 15 for c in x.t.values())


def term_words(x: Lin, n_slots: int) -> list:
    """An entry's terms as the kernel reads them, [slot | c << 16] with c >
    0: -c on slot s is c on its negation n_slots + s; a line slot (n_slots
    + l in the schedule) is 2 n_slots + l."""
    out = []
    for k, c in sorted(x.t.items()):
        if k >= n_slots:
            k += n_slots
        elif c < 0:
            k, c = k + n_slots, -c
        out.append(k + (c << 16))
    return out


def _encode(s: Schedule) -> np.ndarray:
    _check(s)
    level_rows, prod_rows, out_rows, terms = [], [], [], []

    def put(x: Lin) -> list:
        words = term_words(x, s.n_slots)
        terms.extend(words)
        return [len(terms) - len(words), len(words)]

    # offsets are filled in once the sizes are known
    for lv in s.levels:
        if lv.kind == INVERSE:
            level_rows.append([INVERSE, lv.inv[0], lv.inv[1], 0, 0])
            continue
        p0, o0 = len(prod_rows), len(out_rows)
        prod_rows += [[d] + put(a) + put(b) for d, a, b in lv.prods]
        out_rows += [[d] + put(o) for d, o in lv.outs]
        level_rows.append([lv.kind, len(lv.prods), p0, len(lv.outs), o0])
    lev_off = HDR_WORDS
    prod_off = lev_off + 5 * len(level_rows)
    out_off = prod_off + PROD_WORDS * len(prod_rows)
    term_off = out_off + OUT_WORDS * len(out_rows)
    const_off = term_off + len(terms)
    prog_off = const_off + 2 * 9 * len(s.consts)
    words = [s.n_slots, len(level_rows), lev_off, 2 * len(s.consts), const_off, s.in_slot, s.out_slot,
             prog_off, prog_off, len(s.program), s.zero_slot, s.in2_slot, s.in2_len]
    for r in level_rows:
        if r[0] != INVERSE:
            r = [r[0], r[1], prod_off + PROD_WORDS * r[2], r[3], out_off + OUT_WORDS * r[4]]
        words += r
    for r in prod_rows:
        words += [r[0], term_off + r[1], r[2], term_off + r[3], r[4]]
    for r in out_rows:
        words += [r[0], term_off + r[1], r[2]]
    words += terms
    if s.consts:
        consts = s.consts + [(s.n_slots + k, -v % FQ.p) for k, v in s.consts]
        enc = FQ.encode([v for _, v in consts]).T  # (n, 8) Montgomery words
        for (slot, _), w in zip(consts, enc):
            words += [slot] + [int(x) for x in w.view(np.int32)]
    words += list(s.program)
    words += [0] * (-len(words) % 4)
    return np.asarray(words, dtype=np.int64).astype(np.int32)


# ---------------------------------------------------------------------------
# P1: the accumulator, then per fold the square (if flagged) and each pair's
# line
# ---------------------------------------------------------------------------

ML_ACC = 0
ML_PROD = 12
ML_SQ, ML_LINE = 0, 1


def fold_flags() -> np.ndarray:
    """Per fold, whether the accumulator is squared before it: the NAF walk
    (one fold for the doubling step, squared except the first, and one for
    a nonzero digit's addition step) and the 2 final folds."""
    flags = []
    n = len(SIX_U_PLUS_2_NAF)
    for i in range(n - 1, 0, -1):
        flags.append(i != n - 1)
        if SIX_U_PLUS_2_NAF[i - 1] in (1, -1):
            flags.append(False)
    flags += [False, False]
    return np.asarray(flags, dtype=bool)


@lru_cache(maxsize=None)
def miller_loop(n_pairs: int) -> Schedule:
    """P1's schedule for n_pairs >= 1 line records a fold."""
    if n_pairs < 1:
        raise ValueError("the Miller loop needs at least one pair")
    acc = fq12_at(ML_ACC)
    sq = _level(ML_PROD, lambda P: f12_sq(P, acc), ML_ACC)
    n_slots = ML_PROD + 39 + 1  # the products, then the zero slot
    line = [Lin.slot(n_slots + k) for k in range(6)]
    mul = _level(ML_PROD, lambda P: f12_mul_by_034(P, acc, tuple(line[0:2]), tuple(line[2:4]),
                                                   tuple(line[4:6])), ML_ACC, LINE)
    program = []
    for flag in fold_flags():
        program += ([ML_SQ] if flag else []) + [ML_LINE] * n_pairs
    return Schedule("pair_miller_loop", n_slots, [sq, mul], program, [(ML_ACC, 1)], -1, ML_ACC)


# ---------------------------------------------------------------------------
# P2: the easy part, conj(f) f^-1 then frob^2(t) t, with the inverse down the
# tower; then the hard part over the exponent's bits from the lowest
# ---------------------------------------------------------------------------

# slots: the result R, the power T, the input A, U (f^-1, then frob^2(t)),
# the inverse's pieces, the Frobenius constants, then the products
FE_R, FE_T, FE_A, FE_U = 0, 12, 24, 36
FE_S6 = 48  # the inverse's INV_WORK pieces
FE_C = 72  # FROB_FQ6_C1[2], FROB_FQ6_C2[2], FROB_FQ12_C1[2], and the first two times the third
FE_PROD = 82
FE_SQ, FE_MUL, FE_MULSQ = 0, 1, 2
HARD_BITS = [(HARD_PART_EXP >> i) & 1 for i in range(HARD_PART_EXP.bit_length())]


def _frob_consts(power: int, first: int) -> list:
    """x -> x^(q^power)'s constants FROB_FQ6_C1, FROB_FQ6_C2, FROB_FQ12_C1 of
    that power (w), and c1 w and c2 w, as 10 Fq slots from `first`."""
    c1, c2, w = FROB_FQ6_C1[power % 6], FROB_FQ6_C2[power % 6], FROB_FQ12_C1[power]
    vals = []
    for c in (c1, c2, w, c1 * w, c2 * w):
        vals += [c.c0.v, c.c1.v]
    return [(first + k, v) for k, v in enumerate(vals)]


def _frobenius(P, t, c, odd: bool):
    """t^(q^power) from its constants c = (c1, c2, w, c1 w, c2 w), each an
    Fq2 of Lins: every Fq2 conjugated first if the power is odd, then c0.c1 c1,
    c0.c2 c2, c1.c0 w, c1.c1 c1 w, c1.c2 c2 w."""
    if odd:
        t = tuple(tuple((x[0], -x[1]) for x in half) for half in t)
    return ((t[0][0], f2_mul(P, t[0][1], c[0]), f2_mul(P, t[0][2], c[1])),
            (f2_mul(P, t[1][0], c[2]), f2_mul(P, t[1][1], c[3]), f2_mul(P, t[1][2], c[4])))


INV_WORK = 24  # slots the inverse's pieces take


def _inverse_levels(x: int, a_slot: int, w: int, dst: int) -> list:
    """The levels of f^-1 (csrc/pairing.cu f12_inv, f6_inv, f2_inv) for f in
    the slots from a_slot, to dst, with its pieces in the INV_WORK slots from
    w: s = a0^2 - v a1^2, then s^-1 down the tower to one Fermat inverse in
    Fq, then (a0 s^-1, -a1 s^-1); products from slot x."""
    a = fq12_at(a_slot)
    s6, t6, d6 = fq6_at(w), fq6_at(w + 6), fq6_at(w + 18)
    n, di = fq2_at(w + 12), fq2_at(w + 16)
    m, d = Lin.slot(w + 14), Lin.slot(w + 15)
    return [
        _level(x, lambda P: f6_sub(f6_mul(P, a[0], a[0]), f6_mul_nonres(f6_mul(P, a[1], a[1]))), w),
        _level(x, lambda P: [
            f2_sub(f2_sq(P, s6[0]), f2_mul_xi(f2_mul(P, s6[1], s6[2]))),
            f2_sub(f2_mul_xi(f2_sq(P, s6[2])), f2_mul(P, s6[0], s6[1])),
            f2_sub(f2_sq(P, s6[1]), f2_mul(P, s6[0], s6[2]))], w + 6),
        _level(x, lambda P: f2_add(f2_mul(P, s6[0], t6[0]),
                                   f2_mul_xi(f2_add(f2_mul(P, s6[2], t6[1]), f2_mul(P, s6[1], t6[2])))), w + 12),
        _level(x, lambda P: P.mul(n[0], n[0]) + P.mul(n[1], n[1]), w + 14),
        Level(INVERSE, [], [], (w + 14, w + 15)),
        _level(x, lambda P: (P.mul(n[0], d), -P.mul(n[1], d)), w + 16),
        _level(x, lambda P: [f2_mul(P, t6[k], di) for k in range(3)], w + 18),
        _level(x, lambda P: (f6_mul(P, a[0], d6), f6_neg(f6_mul(P, a[1], d6))), dst),
    ]


@lru_cache(maxsize=None)
def final_exp() -> Schedule:
    r, t, a, u = fq12_at(FE_R), fq12_at(FE_T), fq12_at(FE_A), fq12_at(FE_U)
    c = tuple(fq2_at(FE_C + 2 * k) for k in range(5))
    x = FE_PROD
    levels = [
        _level(x, lambda P: [f12_sq(P, t)], FE_T),
        _level(x, lambda P: [f12_mul(P, r, t)], FE_R),
        _level(x, lambda P: [f12_mul(P, r, t), f12_sq(P, t)], FE_R),  # R then T: slots 0-23
        *_inverse_levels(x, FE_A, FE_S6, FE_U),
        # t = conj(f) f^-1, then t = frob^2(t) t
        _level(x, lambda P: f12_mul(P, f12_conj(a), u), FE_T),
        _level(x, lambda P: _frobenius(P, t, c, False), FE_U),
        _level(x, lambda P: f12_mul(P, u, t), FE_T),
    ]
    program = list(range(3, len(levels)))
    last = len(HARD_BITS) - 1
    for i, bit in enumerate(HARD_BITS):
        if i < last:
            program.append(FE_MULSQ if bit else FE_SQ)
        elif bit:
            program.append(FE_MUL)
    n_slots = FE_PROD + max(len(lv.prods) for lv in levels) + 1  # the products, then the zero slot
    return Schedule("pair_final_exp", n_slots, levels, program, [(FE_R, 1)] + _frob_consts(2, FE_C),
                    FE_A, FE_R)


# ---------------------------------------------------------------------------
# P3's schedule route: one tower op on one lane's block. The input Fq12 A in
# slots 0-11, the second operand B from slot 12 (mul: an Fq12; mul_by_034:
# the line's c0, c3, c4), then the op's constants or the inverse's pieces,
# then the products; the result goes to A's slots.
# ---------------------------------------------------------------------------

OP_A, OP_B = 0, 12
F12_OPS = ("mul", "sq", "inv", "frobenius", "conj", "mul_by_034")


def f12_op(op: str, power: int = 0) -> Schedule:
    """P3's `op` (one of F12_OPS; frobenius at `power`, mod 12) as a schedule."""
    return _f12_op(op, power % 12 if op == "frobenius" else 0)


@lru_cache(maxsize=None)
def _f12_op(op: str, power: int) -> Schedule:
    a = fq12_at(OP_A)
    consts, in2 = [], (-1, 0)
    if op == "mul":
        in2, x = (OP_B, 12), OP_B + 12
        levels = [_level(x, lambda P: f12_mul(P, a, fq12_at(OP_B)), OP_A)]
    elif op == "sq":
        x = OP_B
        levels = [_level(x, lambda P: f12_sq(P, a), OP_A)]
    elif op == "mul_by_034":
        in2, x = (OP_B, 6), OP_B + 6
        c0, c3, c4 = (fq2_at(OP_B + 2 * k) for k in range(3))
        levels = [_level(x, lambda P: f12_mul_by_034(P, a, c0, c3, c4), OP_A)]
    elif op == "conj":
        x = OP_B
        levels = [_level(x, lambda P: f12_conj(a), OP_A)]
    elif op == "frobenius":
        x, consts = OP_B + 10, _frob_consts(power, OP_B)
        c = tuple(fq2_at(OP_B + 2 * k) for k in range(5))
        levels = [_level(x, lambda P: _frobenius(P, a, c, power % 2 == 1), OP_A)]
    elif op == "inv":
        x = OP_B + INV_WORK
        levels = _inverse_levels(x, OP_A, OP_B, OP_A)
    else:
        raise ValueError(f"unknown op {op!r}: one of {list(F12_OPS)}")
    n_slots = x + max(len(lv.prods) for lv in levels) + 1  # the products, then the zero slot
    name = f"f12_map {op}" + (f" {power}" if op == "frobenius" else "")
    return Schedule(name, n_slots, levels, list(range(len(levels))), consts, OP_A, OP_A, *in2)
