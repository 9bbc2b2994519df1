"""Pure-Python short-Weierstrass curve oracle: y^2 = x^3 + b (a = 0).

The port's own copy of `kogarashi_tpu/pyref/curve.py`: BN254 G1 and G2, and
Grumpkin.

Generic over the coefficient field (Fq for G1, Fr for Grumpkin, Fq2 for G2).
Provides both branchy affine arithmetic (the obviously-correct path) and the
branchless *complete* homogeneous projective formulas (Renes–Costello–Batina
2016, Algorithms 7/9 for a=0) that the point kernels use — so the formulas
themselves are validated here against the affine path.

Parity: zkstd/src/arithmetic/points/weierstrass.rs, zkstd/src/circuit/gadget/curve.rs:89-158.
"""

from __future__ import annotations


class CurveSpec:
    """b, b3 as field elements; field is the coefficient field class."""

    def __init__(self, name, field, b, generator_xy):
        self.name = name
        self.field = field
        self.b = b
        self.b3 = b + b + b
        self.generator = AffinePoint(self, generator_xy[0], generator_xy[1], False)

    def identity_affine(self):
        # (0, 1, infinity) — matches the reference's ADDITIVE_IDENTITY
        # (zkstd/src/macros/curve/weierstrass/group.rs:22-26); the y=1
        # coordinate is observable through transcript absorption.
        return AffinePoint(self, self.field_zero(), self.field_one(), True)

    def identity_projective(self):
        return ProjectivePoint(self, self.field_zero(), self.field_one(), self.field_zero())

    def field_zero(self):
        return self.field.zero()

    def field_one(self):
        return self.field.one()


class AffinePoint:
    __slots__ = ("spec", "x", "y", "is_infinity")

    def __init__(self, spec, x, y, is_infinity=False):
        self.spec, self.x, self.y, self.is_infinity = spec, x, y, is_infinity

    def is_on_curve(self):
        if self.is_infinity:
            return True
        return self.y.square() == self.x.square() * self.x + self.spec.b

    def __eq__(self, o):
        if self.is_infinity or o.is_infinity:
            return self.is_infinity == o.is_infinity
        return self.x == o.x and self.y == o.y

    def __neg__(self):
        return AffinePoint(self.spec, self.x, -self.y, self.is_infinity)

    def __add__(self, o):
        if self.is_infinity:
            return o
        if o.is_infinity:
            return self
        if self.x == o.x:
            if self.y == o.y:
                return self.double()
            return self.spec.identity_affine()
        lam = (o.y - self.y) * (o.x - self.x).invert()
        x3 = lam.square() - self.x - o.x
        y3 = lam * (self.x - x3) - self.y
        return AffinePoint(self.spec, x3, y3, False)

    def __sub__(self, o):
        return self + (-o)

    def double(self):
        if self.is_infinity or self.y.is_zero():
            return self.spec.identity_affine()
        three = self.spec.field_one() + self.spec.field_one() + self.spec.field_one()
        lam = three * self.x.square() * (self.y.double()).invert()
        x3 = lam.square() - self.x.double()
        y3 = lam * (self.x - x3) - self.y
        return AffinePoint(self.spec, x3, y3, False)

    def __mul__(self, k: int):
        acc = self.spec.identity_affine()
        base = self
        while k:
            if k & 1:
                acc = acc + base
            base = base.double()
            k >>= 1
        return acc

    __rmul__ = __mul__

    def to_projective(self):
        if self.is_infinity:
            return self.spec.identity_projective()
        return ProjectivePoint(self.spec, self.x, self.y, self.spec.field_one())

    def __repr__(self):
        if self.is_infinity:
            return f"{self.spec.name}(inf)"
        return f"{self.spec.name}({self.x!r}, {self.y!r})"


def batch_to_affine(projs):
    """Convert many ProjectivePoints to affine with ONE field inversion
    (Montgomery's trick): 3(n-1) muls + 1 invert instead of n inverts."""
    if not projs:
        return []
    spec = projs[0].spec
    one = spec.field_one()
    acc = one
    prefix = []
    for q in projs:
        prefix.append(acc)
        if not q.z.is_zero():
            acc = acc * q.z
    inv = acc.invert()
    out = [None] * len(projs)
    for i in range(len(projs) - 1, -1, -1):
        q = projs[i]
        if q.z.is_zero():
            out[i] = spec.identity_affine()
        else:
            zinv = inv * prefix[i]
            inv = inv * q.z
            out[i] = AffinePoint(spec, q.x * zinv, q.y * zinv, False)
    return out


class ProjectivePoint:
    """Homogeneous projective (X:Y:Z); identity = (0:1:0). Complete formulas."""

    __slots__ = ("spec", "x", "y", "z")

    def __init__(self, spec, x, y, z):
        self.spec, self.x, self.y, self.z = spec, x, y, z

    def is_identity(self):
        return self.z.is_zero()

    def to_affine(self):
        if self.z.is_zero():
            return self.spec.identity_affine()
        zinv = self.z.invert()
        return AffinePoint(self.spec, self.x * zinv, self.y * zinv, False)

    def __eq__(self, o):
        # (X1:Y1:Z1) == (X2:Y2:Z2) iff cross-products match
        return (
            self.x * o.z == o.x * self.z
            and self.y * o.z == o.y * self.z
            and self.is_identity() == o.is_identity()
        )

    def __neg__(self):
        return ProjectivePoint(self.spec, self.x, -self.y, self.z)

    def __add__(self, o):
        """RCB 2016 Algorithm 7 (a=0), complete — mirrors the TPU kernel exactly."""
        b3 = self.spec.b3
        x1, y1, z1 = self.x, self.y, self.z
        x2, y2, z2 = o.x, o.y, o.z
        t0 = x1 * x2
        t1 = y1 * y2
        t2 = z1 * z2
        t3 = (x1 + y1) * (x2 + y2) - t0 - t1
        t4 = (y1 + z1) * (y2 + z2) - t1 - t2
        t5 = (x1 + z1) * (x2 + z2) - t0 - t2
        t6 = t0 + t0 + t0  # 3*X1X2
        t2b3 = t2 * b3
        zz = t1 + t2b3
        tt = t1 - t2b3
        y5 = t5 * b3
        x3 = t4 * y5
        x3 = t3 * tt - x3
        y3 = y5 * t6 + tt * zz
        z3 = zz * t4 + t6 * t3
        return ProjectivePoint(self.spec, x3, y3, z3)

    def double(self):
        """RCB 2016 Algorithm 9 (a=0), complete."""
        b3 = self.spec.b3
        x, y, z = self.x, self.y, self.z
        t0 = y.square()
        z3 = t0.double().double().double()  # 8Y^2
        t1 = y * z
        t2 = z.square() * b3
        x3 = t2 * z3
        y3 = t0 + t2
        z3 = t1 * z3
        t1 = t2.double()
        t2 = t1 + t2
        t0 = t0 - t2
        y3 = t0 * y3 + x3
        t1 = x * y
        x3 = (t0 * t1).double()
        return ProjectivePoint(self.spec, x3, y3, z3)

    def __mul__(self, k: int):
        acc = self.spec.identity_projective()
        base = self
        while k:
            if k & 1:
                acc = acc + base
            base = base.double()
            k >>= 1
        return acc

    __rmul__ = __mul__

    def __repr__(self):
        return f"{self.spec.name}P({self.x!r}:{self.y!r}:{self.z!r})"


def make_specs():
    from .. import constants as C
    from .field import Fq, Fr

    g1 = CurveSpec("G1", Fq, Fq(C.G1_B), (Fq(C.G1_GEN[0]), Fq(C.G1_GEN[1])))
    grumpkin = CurveSpec(
        "Grumpkin", Fr, Fr(C.GRUMPKIN_B), (Fr(C.GRUMPKIN_GEN[0]), Fr(C.GRUMPKIN_GEN[1]))
    )
    return g1, grumpkin


G1_SPEC, GRUMPKIN_SPEC = make_specs()
