"""Coefficient-based optimal-ate pairing (the production formulation).

Parity: bn254/src/g2.rs:213-310 (G2 pairing precompute, eprint 2010/354
Algorithms 26/27), bn254/src/pairing.rs (NAF Miller loop over precomputed
line coefficients), bn254/src/fqn.rs:26-36 (untwist = mul_by_034 with
G1-scaled coefficients) and final_exp (easy part + hard part; the hard part
here is a generic cyclotomic exponentiation by (q^4 - q^2 + 1)/r, which
equals the reference's BN_X chain output).

The port's own copy of `kogarashi_tpu/pyref/pairing_fast.py`, which the JAX
package tests against its transparent affine pairing (pyref/pairing.py);
tests/test_torch_host.py holds the two copies' verdicts equal.
"""

from __future__ import annotations

from .. import constants as C
from .field import Fq
from .tower import FROB_FQ6_C1, Fq2, Fq6, Fq12
from .curve import AffinePoint, G2_SPEC

# NAF decomposition of 6x+2 used by the reference (pairing.rs:5-9).
# Derived: value = sum naf[i] * 2^i.
SIX_U_PLUS_2_NAF = [
    0, 0, 0, 1, 0, 1, 0, -1, 0, 0, 1, -1, 0, 0, 1, 0, 0, 1, 1, 0, -1, 0, 0,
    1, 0, -1, 0, 0, 0, 0, 1, 1, 1, 0, 0, -1, 0, 0, 1, 0, 0, 0, 0, 0, -1, 0,
    0, 1, 1, 0, 0, -1, 0, 0, 0, 1, 1, 0, -1, 0, 0, 1, 0, 1, 1,
]
assert sum(d << i for i, d in enumerate(SIX_U_PLUS_2_NAF)) == C.SIX_X_PLUS_2

# xi^((q-1)/2) — the y-coordinate Frobenius twist constant (pairing.rs:11).
XI_TO_Q_MINUS_1_OVER_2 = Fq2.new(9, 1) ** ((C.Q - 1) // 2)


class G2Prepared:
    """Precomputed Miller-loop line coefficients for a fixed G2 point."""

    __slots__ = ("coeffs", "is_infinity")

    def __init__(self, coeffs, is_infinity):
        self.coeffs = coeffs
        self.is_infinity = is_infinity

    @classmethod
    def from_affine(cls, q: AffinePoint) -> "G2Prepared":
        assert q.spec is G2_SPEC
        if q.is_infinity:
            return cls([], True)
        coeffs = []
        r = _JacobianG2(q.x, q.y, Fq2.one())
        neg = -q
        for i in range(len(SIX_U_PLUS_2_NAF) - 1, 0, -1):
            coeffs.append(r.double_eval())
            x = SIX_U_PLUS_2_NAF[i - 1]
            if x == 1:
                coeffs.append(r.add_eval(q))
            elif x == -1:
                coeffs.append(r.add_eval(neg))

        # Frobenius-twisted final additions (g2.rs:288-305)
        q1x = q.x.conjugate() * FROB_FQ6_C1[1]
        q1y = q.y.conjugate() * XI_TO_Q_MINUS_1_OVER_2
        coeffs.append(r.add_eval_xy(q1x, q1y))

        mq2x = q.x * FROB_FQ6_C1[2]
        coeffs.append(r.add_eval_xy(mq2x, q.y))
        return cls(coeffs, False)


class _JacobianG2:
    """Jacobian-coordinate G2 walker emitting line coefficients."""

    __slots__ = ("x", "y", "z")

    def __init__(self, x, y, z):
        self.x, self.y, self.z = x, y, z

    def double_eval(self):
        """eprint 2010/354 Algorithm 26 (g2.rs:213)."""
        tmp0 = self.x.square()
        tmp1 = self.y.square()
        tmp2 = tmp1.square()
        tmp3 = ((tmp1 + self.x).square() - tmp0 - tmp2).double()
        tmp4 = tmp0.double() + tmp0
        tmp6 = self.x + tmp4
        tmp5 = tmp4.square()
        zsq = self.z.square()
        self.x = tmp5 - tmp3.double()
        self.z = (self.z + self.y).square() - tmp1 - zsq
        self.y = (tmp3 - self.x) * tmp4 - tmp2.double().double().double()
        c1 = -((tmp4 * zsq).double())
        c2 = tmp6.square() - tmp0 - tmp5 - tmp1.double().double()
        c0 = (self.z * zsq).double()
        return (c0, c1, c2)

    def add_eval(self, rhs: AffinePoint):
        return self.add_eval_xy(rhs.x, rhs.y)

    def add_eval_xy(self, rx, ry):
        """eprint 2010/354 Algorithm 27 (g2.rs:237)."""
        zsq = self.z.square()
        ysq = ry.square()
        t0 = zsq * rx
        t1 = ((ry + self.z).square() - ysq - zsq) * zsq
        t2 = t0 - self.x
        t3 = t2.square()
        t4 = t3.double().double()
        t5 = t4 * t2
        t6 = t1 - self.y.double()
        t9 = t6 * rx
        t7 = t4 * self.x
        self.x = t6.square() - t5 - t7.double()
        self.z = (self.z + t2).square() - zsq - t3
        t10 = ry + self.z
        t8 = (t7 - self.x) * t6
        t0 = self.y * t5
        self.y = t8 - t0.double()
        t10 = t10.square() - ysq - self.z.square()
        t9 = t9.double() - t10
        c0 = self.z.double()
        c1 = -(t6.double())
        return (c0, c1, t9)


def untwist_fold(acc: Fq12, coeff, p: AffinePoint) -> Fq12:
    """acc * line, with c0 scaled by p.y and c1 by p.x (fqn.rs:26)."""
    c0, c1, c2 = coeff
    c0 = Fq2(c0.c0 * p.y, c0.c1 * p.y)
    c1 = Fq2(c1.c0 * p.x, c1.c1 * p.x)
    return acc.mul_by_034(c0, c1, c2)


def multi_miller_loop(pairs) -> Fq12:
    """pairs: [(G1 AffinePoint, G2Prepared)] (pairing.rs:38-83)."""
    live = [
        (p, iter(q.coeffs))
        for p, q in pairs
        if not p.is_infinity and not q.is_infinity
    ]
    acc = Fq12.one()
    n = len(SIX_U_PLUS_2_NAF)
    for i in range(n - 1, 0, -1):
        if i != n - 1:
            acc = acc.square()
        for p, coeffs in live:
            acc = untwist_fold(acc, next(coeffs), p)
        x = SIX_U_PLUS_2_NAF[i - 1]
        if x in (1, -1):
            for p, coeffs in live:
                acc = untwist_fold(acc, next(coeffs), p)
    for _ in range(2):
        for p, coeffs in live:
            acc = untwist_fold(acc, next(coeffs), p)
    return acc


# hard-part exponent (q^4 - q^2 + 1) / r — integer, used by generic
# cyclotomic exponentiation; equals the reference BN_X chain's exponent.
HARD_PART_EXP = (C.Q**4 - C.Q**2 + 1) // C.R
assert (C.Q**4 - C.Q**2 + 1) % C.R == 0


def final_exp_fast(f: Fq12) -> Fq12:
    """f^((q^12-1)/r) via easy part + cyclotomic hard part."""
    # easy part: f^(q^6 - 1) then ^(q^2 + 1)
    t = f.conjugate() * f.invert()
    t = t.frobenius(2) * t
    # hard part
    return t**HARD_PART_EXP


def pairing_fast(p: AffinePoint, q: AffinePoint) -> Fq12:
    return final_exp_fast(multi_miller_loop([(p, G2Prepared.from_affine(q))]))
