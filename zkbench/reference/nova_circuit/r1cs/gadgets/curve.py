"""In-circuit projective point gadget (complete RCB16 formulas).

The port's own copy of `kogarashi_tpu/r1cs/gadgets/curve.py`. Parity:
zkstd/src/circuit/gadget/curve.rs — the same Algorithm 7/9 as the point
kernels (csrc/ec.cu), expressed over FieldAssignments so Nova's NIFS
verification circuit can fold commitments. The curve arithmetized here
is `cs.driver.curve` (Grumpkin inside Fr circuits, G1 inside Fq circuits).
"""

from __future__ import annotations

from ...pyref.curve import AffinePoint
from .binary import BinaryAssignment
from .field import FieldAssignment as FA


class PointAssignment:
    __slots__ = ("x", "y", "z")

    def __init__(self, x: FA, y: FA, z: FA):
        self.x, self.y, self.z = x, y, z

    # -- allocation --------------------------------------------------------
    @classmethod
    def instance(cls, cs, point):
        """point: pyref AffinePoint over the driver's in-circuit curve."""
        x = FA.instance(cs, point.x.v)
        y = FA.instance(cs, point.y.v)
        z = FA.instance(cs, 0 if point.is_infinity else 1)
        return cls(x, y, z)

    @classmethod
    def witness(cls, cs, x_val: int, y_val: int, is_infinity: bool):
        x = FA.witness(cs, x_val)
        y = FA.witness(cs, y_val)
        z = FA.witness(cs, 0 if is_infinity else 1)
        return cls(x, y, z)

    @classmethod
    def identity(cls, cs):
        return cls(FA.constant(cs, 0), FA.constant(cs, 1), FA.constant(cs, 0))

    def value(self, cs):
        """Evaluate to a pyref AffinePoint (for tests/host logic)."""
        spec = cs.driver.curve
        F = cs.driver.scalar
        zv = self.z.value(cs)
        if zv == 0:
            return spec.identity_affine()
        zi = pow(zv, -1, cs.p)

        return AffinePoint(
            spec, F(self.x.value(cs) * zi), F(self.y.value(cs) * zi), False
        )

    # -- constraints -------------------------------------------------------
    def assert_equal_public_point(self, cs, proj_x: int, proj_y: int, proj_z: int):
        """Cross-multiplication equality with a public projective point."""
        px, py, pz = (FA.constant(cs, v) for v in (proj_x, proj_y, proj_z))
        FA.enforce_eq(cs, FA.mul(cs, self.x, pz), FA.mul(cs, px, self.z))
        FA.enforce_eq(cs, FA.mul(cs, self.y, pz), FA.mul(cs, py, self.z))

    def add(self, cs, rhs: "PointAssignment") -> "PointAssignment":
        """Complete add (RCB16 Alg 7, a=0) — curve.rs:89-130."""
        b3 = FA.constant(cs, cs.driver.b3())
        t0 = FA.mul(cs, self.x, rhs.x)
        t1 = FA.mul(cs, self.y, rhs.y)
        t2 = FA.mul(cs, self.z, rhs.z)
        t3 = FA.mul(cs, self.x + self.y, rhs.x + rhs.y) - (t0 + t1)
        t4 = FA.mul(cs, self.y + self.z, rhs.y + rhs.z) - (t1 + t2)
        x3 = FA.mul(cs, self.x + self.z, rhs.x + rhs.z)
        y3 = x3 - (t0 + t2)
        x3 = t0 + t0
        t0 = x3 + t0
        t2 = FA.mul(cs, t2, b3)
        z3 = t1 + t2
        t1 = t1 - t2
        y3 = FA.mul(cs, y3, b3)
        x3 = FA.mul(cs, t3, t1) - FA.mul(cs, t4, y3)
        y3 = FA.mul(cs, y3, t0) + FA.mul(cs, t1, z3)
        z3 = FA.mul(cs, z3, t4) + FA.mul(cs, t0, t3)
        return PointAssignment(x3, y3, z3)

    def double(self, cs) -> "PointAssignment":
        """Complete doubling (RCB16 Alg 9, a=0) — curve.rs:132-158."""
        b3 = FA.constant(cs, cs.driver.b3())
        t0 = FA.mul(cs, self.y, self.y)
        z3 = t0 + t0
        z3 = z3 + z3
        z3 = z3 + z3
        t1 = FA.mul(cs, self.y, self.z)
        t2 = FA.mul(cs, self.z, self.z)
        t2 = FA.mul(cs, t2, b3)
        x3 = FA.mul(cs, t2, z3)
        y3 = t0 + t2
        z3 = FA.mul(cs, t1, z3)
        t1 = t2 + t2
        t2 = t1 + t2
        t0 = t0 - t2
        y3 = FA.mul(cs, t0, y3) + x3
        t1 = FA.mul(cs, self.x, self.y)
        x3 = FA.mul(cs, t0, t1)
        x3 = x3 + x3
        return PointAssignment(x3, y3, z3)

    def scalar_point(self, cs, scalar: FA) -> "PointAssignment":
        """256-bit double-and-add with identity-select (curve.rs:161)."""
        res = PointAssignment.identity(cs)
        for bit in FA.to_bits(cs, scalar, 256):
            res = res.double(cs)
            res = res.add(cs, self.select_identity(cs, bit))
        return res

    def select_identity(self, cs, bit: BinaryAssignment) -> "PointAssignment":
        """bit ? self : identity  — (x*b, y*b + 1 - b, z*b)."""
        bf = FA.from_binary_in(cs, bit)
        one = FA.constant(cs, 1)
        return PointAssignment(
            FA.mul(cs, self.x, bf),
            (FA.mul(cs, self.y, bf) + one) - bf,
            FA.mul(cs, self.z, bf),
        )

    @classmethod
    def conditional_select(cls, cs, a, b, condition: BinaryAssignment):
        return cls(
            FA.conditional_select(cs, a.x, b.x, condition),
            FA.conditional_select(cs, a.y, b.y, condition),
            FA.conditional_select(cs, a.z, b.z, condition),
        )

    def descale(self, cs) -> "PointAssignment":
        """Normalize z to 1 (or identity) — curve.rs:34."""
        nonzero = FA.is_neq(cs, self.z, FA.constant(cs, 0))
        zv = self.z.value(cs)
        inv_val = pow(zv, -1, cs.p) if zv else 0
        inv = FA.witness(cs, inv_val)
        p = PointAssignment(
            FA.mul(cs, self.x, inv),
            FA.mul(cs, self.y, inv),
            FA.constant(cs, 1),
        )
        return p.select_identity(cs, nonzero)
