"""Subgroup / torsion checks for BN254 G1 and G2 (and on-curve validation).

The port's own copy of `kogarashi_tpu/pyref/subgroup.py`; the proof decoders
(`utils/serde.py`) validate every point they read with it.

Parity:
  - G1: GLV-endomorphism check, bn254/src/g1.rs:9-72 (eprint 2021/1130 §6,
    correctness eprint 2022/352): endo(P) == -[x^2]P where endo(x,y) =
    (BETA*x, y) and BETA is a nontrivial cube root of unity. BN254 G1 has
    cofactor 1, so this is equivalent to the on-curve check — implemented for
    parity and as a self-check.
  - G2: psi/mul_by_x check, bn254/src/g2.rs:88-145: P is in the r-order
    subgroup iff psi(P) == [x]P, where psi is the untwist-Frobenius-twist
    endomorphism. G2's cofactor is ~q, so this check is security-critical for
    any point decoded from attacker bytes.

All constants are DERIVED here (cube root of unity, (u+1)-power Frobenius
coefficients) and asserted against the reference's Montgomery-form constants
(g1.rs:9-14, g2.rs:112-135) at import time.
"""

from __future__ import annotations

from .. import constants as C
from .curve import G1_SPEC, G2_SPEC, AffinePoint
from .field import Fq
from .tower import Fq2

_MONT_RINV = pow(1 << 256, -1, C.Q)


def _from_mont_limbs(limbs4) -> int:
    v = sum(l << (64 * i) for i, l in enumerate(limbs4))
    return v * _MONT_RINV % C.Q


# ---------------------------------------------------------------------------
# G1: BETA and the GLV check
# ---------------------------------------------------------------------------

# A nontrivial cube root of unity mod q, paired with the matching eigenvalue
# lambda (a cube root of unity mod r) such that endo(P) == [lambda]P on the
# whole subgroup.
#
# DELIBERATE DEVIATION from the reference: g1.rs:9-14's BETA constant is not
# a cube root of unity mod the BN254 q under any limb-order/Montgomery
# interpretation, and its check `endo(P) == -[x^2]P` (g1.rs:61-71) is the
# BLS12-381 identity (lambda = -x^2 holds for the BLS12-381 r, not BN254's) —
# both look like imports from a BLS12-381 codebase. The code is dead-safe in
# the reference because BN254 G1 has cofactor 1 (on-curve implies in-subgroup),
# but replicating it would make every honest point fail. We derive the correct
# (BETA, LAMBDA) pair and check the genuine eigenvalue identity instead.
def _derive_beta_lambda():
    def cube_roots(m):
        g = 2
        while pow(g, (m - 1) // 2, m) == 1:
            g += 1
        w = pow(g, (m - 1) // 3, m)
        return w, pow(w, 2, m)

    gp = G1_SPEC.generator
    for b in cube_roots(C.Q):
        endo = AffinePoint(gp.spec, gp.x * Fq(b), gp.y, False)
        for lam in cube_roots(C.R):
            if endo == lam * gp:
                return Fq(b), lam
    raise AssertionError("no (beta, lambda) pair matches the endomorphism")


BETA, LAMBDA = _derive_beta_lambda()
assert BETA.v != 1 and pow(BETA.v, 3, C.Q) == 1
assert pow(LAMBDA, 3, C.R) == 1 and (LAMBDA * LAMBDA + LAMBDA + 1) % C.R == 0


def g1_endomorphism(p: AffinePoint) -> AffinePoint:
    """(x, y) -> (BETA*x, y) — the GLV endomorphism (g1.rs:24-31)."""
    if p.is_infinity:
        return p
    return AffinePoint(p.spec, p.x * BETA, p.y, False)


def g1_is_torsion_free(p: AffinePoint) -> bool:
    """Subgroup check via the GLV eigenvalue identity endo(P) == [lambda]P.

    Replaces g1.rs:61-71 (see the deviation note above). For BN254 G1 the
    cofactor is 1, so this holds for every on-curve point — it doubles as a
    consistency self-check rather than a security gate.
    """
    if p.is_infinity:
        return True
    return g1_endomorphism(p) == LAMBDA * p


# ---------------------------------------------------------------------------
# G2: psi endomorphism and the [x]P check
# ---------------------------------------------------------------------------

# psi = untwist-Frobenius-twist endomorphism of the D-type twist:
#   psi(x, y) = (xi^((q-1)/3) * conj(x), xi^((q-1)/2) * conj(y)),  xi = 9 + u
# (the tower nonresidue). On the r-order subgroup psi(P) = [t-1]P = [6x^2]P.
#
# DELIBERATE DEVIATION from the reference: g2.rs:110-144's psi coefficients
# are powers of (u+1) — the BLS12-381 twist line — and its check
# `psi(P) == [x]P` (g2.rs:26-33) is the BLS12-381 identity. Neither holds on
# BN254 (the reference's own constants fail psi(G2_gen) == [x]G2_gen). We use
# the BN-curve membership test psi(P) == [6x^2]P (eprint 2022/348 §3.1, the
# check production BN254 libraries use), with coefficients derived from xi.
PSI_X = Fq2.new(9, 1) ** ((C.Q - 1) // 3)
PSI_Y = Fq2.new(9, 1) ** ((C.Q - 1) // 2)
_PSI_EIGEN = 6 * C.BN_X * C.BN_X % C.R  # t - 1 == q mod r


def g2_psi(p: AffinePoint) -> AffinePoint:
    """psi(x, y) = (psi_x * conj(x), psi_y * conj(y))."""
    if p.is_infinity:
        return p
    return AffinePoint(
        p.spec, p.x.conjugate() * PSI_X, p.y.conjugate() * PSI_Y, False
    )


def g2_is_torsion_free(p: AffinePoint) -> bool:
    """P in the r-order subgroup iff psi(P) == [6x^2]P (eprint 2022/348)."""
    if p.is_infinity:
        return True
    return g2_psi(p) == _PSI_EIGEN * p


# ---------------------------------------------------------------------------
# Unified point validation (for serde decode paths)
# ---------------------------------------------------------------------------


def validate_point(p: AffinePoint) -> bool:
    """On-curve + subgroup membership for any of the three curves."""
    if p.is_infinity:
        return True
    if not p.is_on_curve():
        return False
    if p.spec is G2_SPEC:
        return g2_is_torsion_free(p)
    if p.spec is G1_SPEC:
        return g1_is_torsion_free(p)
    # Grumpkin: prime order, cofactor 1 — on-curve is sufficient
    return True
