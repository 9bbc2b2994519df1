"""Pure-Python optimal-ate pairing oracle for BN254.

Implemented in the most transparent way possible: G2 points are untwisted into
E(Fq12) via psi(x, y) = (x*w^2, y*w^3), the Miller loop runs with affine line
functions in Fq12, and the final exponentiation is the brute-force
f^((q^12-1)/r). Slow but unambiguous — the fast path (precomputed line
coefficients, cyclotomic final-exp chain) is tested against this.

Parity: bn254/src/pairing.rs (multi_miller_loop / final_exp), bn254/src/g2.rs
(G2PairingAffine precompute).

The port's own copy of `kogarashi_tpu/pyref/pairing.py`; tests/test_torch_host.py
holds the two copies' values equal.
"""

from __future__ import annotations

from .. import constants as C
from .field import Fq
from .tower import Fq2, Fq6, Fq12
from .curve import AffinePoint, G1_SPEC, G2_SPEC

_QTO12 = C.Q**12
GT_ORDER_COFACTOR = (_QTO12 - 1) // C.R


def _w_pow(k: int) -> Fq12:
    """w^k as an Fq12 element (w^2 = v, v^3 = xi)."""
    coeffs = [Fq2.zero() for _ in range(6)]  # basis 1, w^2=v, w^4=v^2 in c0; w, w^3, w^5 in c1
    # Fq12 = c0 + c1*w with c0,c1 in Fq6 = d0 + d1*v + d2*v^2
    assert 0 <= k < 6
    half, odd = divmod(k, 2)
    six = [Fq2.zero()] * 3
    six = list(six)
    six[half] = Fq2.one()
    f6 = Fq6(*six)
    if odd:
        return Fq12(Fq6.zero(), f6)
    return Fq12(f6, Fq6.zero())


W2 = _w_pow(2)
W3 = _w_pow(3)


def fq_to_fq12(a: Fq) -> Fq12:
    return Fq12(Fq6(Fq2(a, Fq(0)), Fq2.zero(), Fq2.zero()), Fq6.zero())


def fq2_to_fq12(a: Fq2) -> Fq12:
    return Fq12(Fq6(a, Fq2.zero(), Fq2.zero()), Fq6.zero())


def untwist(q: AffinePoint):
    """E'(Fq2) -> E(Fq12): (x, y) -> (x w^2, y w^3). bn254/src/fqn.rs:26 analogue."""
    assert q.spec is G2_SPEC
    return (fq2_to_fq12(q.x) * W2, fq2_to_fq12(q.y) * W3)


def _line(t, q, p) -> Fq12:
    """Affine line through t and q (or tangent if t==q), evaluated at p.

    t, q: (X, Y) tuples of Fq12; p: (px, py) tuple of Fq12.
    """
    tx, ty = t
    qx, qy = q
    px, py = p
    if tx == qx and ty == qy:
        # tangent
        three = fq_to_fq12(Fq(3))
        lam = three * tx.square() * (ty + ty).invert()
    elif tx == qx:
        # vertical
        return px - tx
    else:
        lam = (qy - ty) * (qx - tx).invert()
    return (py - ty) - lam * (px - tx)


def _add_pts(t, q):
    tx, ty = t
    qx, qy = q
    if tx == qx and ty == qy:
        three = fq_to_fq12(Fq(3))
        lam = three * tx.square() * (ty + ty).invert()
    elif tx == qx:
        return None  # infinity
    else:
        lam = (qy - ty) * (qx - tx).invert()
    x3 = lam.square() - tx - qx
    y3 = lam * (tx - x3) - ty
    return (x3, y3)


def miller_loop(p: AffinePoint, q: AffinePoint) -> Fq12:
    """f_{6x+2,Q}(P) * l_{[6x+2]Q,piQ}(P) * l_{[6x+2]Q+piQ,-pi2Q}(P)."""
    assert p.spec is G1_SPEC and q.spec is G2_SPEC
    if p.is_infinity or q.is_infinity:
        return Fq12.one()
    qq = untwist(q)
    pp = (fq_to_fq12(p.x), fq_to_fq12(p.y))

    f = Fq12.one()
    t = qq
    bits = bin(C.SIX_X_PLUS_2)[2:]
    for bit in bits[1:]:
        f = f.square() * _line(t, t, pp)
        t = _add_pts(t, t)
        if bit == "1":
            f = f * _line(t, qq, pp)
            t = _add_pts(t, qq)

    # Frobenius correction lines: Q1 = pi(Q), Q2 = pi^2(Q)
    q1 = (qq[0].frobenius(1), qq[1].frobenius(1))
    q2 = (qq[0].frobenius(2), qq[1].frobenius(2))
    f = f * _line(t, q1, pp)
    t = _add_pts(t, q1)
    nq2 = (q2[0], -q2[1])
    f = f * _line(t, nq2, pp)
    return f


def final_exp(f: Fq12) -> Fq12:
    """Brute-force f^((q^12-1)/r)."""
    return f**GT_ORDER_COFACTOR


def pairing(p: AffinePoint, q: AffinePoint) -> Fq12:
    return final_exp(miller_loop(p, q))
