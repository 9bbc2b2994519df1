"""Pure-Python twisted Edwards (a = -1) curve oracle + Jubjub instance.

The port's own copy of `kogarashi_tpu/pyref/edwards.py`. Its classes are not
the JAX package's: tests compare the two by integer coordinates and bytes.

Mirrors the reference's generic Edwards layer:
  - extended-coordinate (X, Y, T, Z) add/double/mixed/scalar formulas:
    zkstd/src/arithmetic/points/edwards.rs:6-131 (same variable naming)
  - affine/extended trait surface: zkstd/src/traits/curve/edwards.rs
  - 32-byte point compression (y || sign(x) in the top bit):
    zkstd/tests/jubjub.rs `SigUtils<32> for JubjubAffine`
  - Jubjub-over-BLS12-381-scalar instantiation: zkstd/tests/jubjub.rs
    (EDWARDS_D, generator X/Y, S = 32)

All formulas are the unified a = -1 ones (complete for d a non-square), so
the batched point ops (curves/edwards.py, csrc/edwards.cu) are branchless by
construction; this oracle validates them.
"""

from __future__ import annotations

from .. import constants as C
from .field import PrimeField


class BlsScalar(PrimeField):
    """BLS12-381 scalar field = Jubjub base field (zkstd/tests/jubjub.rs)."""

    p = C.BLS_FR
    generator = C.BLS_FR_GENERATOR
    s = C.BLS_FR_S
    t = C.BLS_FR_T
    root_of_unity = C.BLS_FR_ROOT_OF_UNITY


class EdwardsSpec:
    """Twisted Edwards curve -x^2 + y^2 = 1 + d x^2 y^2 over `field`."""

    def __init__(self, name, field, d, generator_xy, order, cofactor=1):
        self.name = name
        self.field = field
        self.d = d
        self.order = order  # prime-order subgroup size (scalar modulus)
        self.cofactor = cofactor
        self.generator = EdwardsAffine(self, generator_xy[0], generator_xy[1])

    def identity_affine(self):
        return EdwardsAffine(self, self.field.zero(), self.field.one())

    def identity_extended(self):
        z = self.field.zero()
        o = self.field.one()
        return EdwardsExtended(self, z, o, z, o)


class EdwardsAffine:
    __slots__ = ("spec", "x", "y")

    def __init__(self, spec, x, y):
        self.spec, self.x, self.y = spec, x, y

    def is_identity(self):
        return self.x.is_zero() and self.y == self.spec.field.one()

    def is_on_curve(self):
        """-x^2 + y^2 == 1 + d x^2 y^2."""
        x2, y2 = self.x.square(), self.y.square()
        return y2 - x2 == self.spec.field.one() + self.spec.d * x2 * y2

    def __eq__(self, o):
        return self.x == o.x and self.y == o.y

    def __neg__(self):
        return EdwardsAffine(self.spec, -self.x, self.y)

    def __add__(self, o):
        if isinstance(o, EdwardsExtended):
            return add_mixed_point(self, o)
        return add_affine_point(self, o)

    def __sub__(self, o):
        return self + (-o)

    def double(self):
        return double_affine_point(self)

    def __mul__(self, k: int):
        return scalar_point(self.to_extended(), k)

    __rmul__ = __mul__

    def to_extended(self):
        return EdwardsExtended(
            self.spec, self.x, self.y, self.x * self.y, self.spec.field.one()
        )

    # -- 32-byte compression (zkstd/tests/jubjub.rs SigUtils<32>) ----------
    def to_bytes(self) -> bytes:
        b = bytearray(self.y.to_bytes())
        b[31] |= (self.x.v & 1) << 7
        return bytes(b)

    @classmethod
    def from_bytes(cls, spec, b: bytes):
        sign = (b[31] >> 7) == 1
        yb = bytearray(b)
        yb[31] &= 0x7F
        y = spec.field.from_bytes(bytes(yb))
        if y is None:
            return None
        y2 = y.square()
        den = y2 * spec.d + spec.field.one()
        num = y2 - spec.field.one()
        den_inv = den.invert()
        if den_inv is None:
            return None
        x = (num * den_inv).sqrt()
        if x is None:
            return None
        if bool(x.v & 1) ^ sign:
            x = -x
        return cls(spec, x, y)

    def __repr__(self):
        return f"{self.spec.name}({self.x!r}, {self.y!r})"


class EdwardsExtended:
    """Extended coordinates (X, Y, T, Z), T = XY/Z; identity (0:1:0:1)."""

    __slots__ = ("spec", "x", "y", "t", "z")

    def __init__(self, spec, x, y, t, z):
        self.spec, self.x, self.y, self.t, self.z = spec, x, y, t, z

    def is_identity(self):
        return self.x.is_zero() and self.y == self.z

    def is_on_curve(self):
        """(Y^2 - X^2) Z^2 == Z^4 + d X^2 Y^2  and  T Z == X Y."""
        x2, y2, z2 = self.x.square(), self.y.square(), self.z.square()
        eq = (y2 - x2) * z2 == z2.square() + self.spec.d * x2 * y2
        return eq and self.t * self.z == self.x * self.y

    def to_affine(self):
        zinv = self.z.invert()
        return EdwardsAffine(self.spec, self.x * zinv, self.y * zinv)

    def __eq__(self, o):
        return (
            self.x * o.z == o.x * self.z
            and self.y * o.z == o.y * self.z
        )

    def __neg__(self):
        return EdwardsExtended(self.spec, -self.x, self.y, -self.t, self.z)

    def __add__(self, o):
        if isinstance(o, EdwardsAffine):
            return add_mixed_point(o, self)
        return add_projective_point(self, o)

    def __sub__(self, o):
        return self + (-o)

    def double(self):
        return double_projective_point(self)

    def __mul__(self, k: int):
        return scalar_point(self, k)

    __rmul__ = __mul__

    def to_bytes(self) -> bytes:
        return self.to_affine().to_bytes()

    def __repr__(self):
        return f"{self.spec.name}E({self.x!r}:{self.y!r}:{self.t!r}:{self.z!r})"


# -- free-function formulas, mirroring zkstd/src/arithmetic/points/edwards.rs --


def add_affine_point(lhs: EdwardsAffine, rhs: EdwardsAffine) -> EdwardsExtended:
    """Unified affine + affine -> extended (edwards.rs:7-25). 9M+4A+2B."""
    spec = lhs.spec
    one = spec.field.one()
    x0, y0, x1, y1 = lhs.x, lhs.y, rhs.x, rhs.y
    a = x0 * x1
    b = y0 * y1
    c = spec.d * a * b
    h = a + b
    e = (x0 + y0) * (x1 + y1) - h
    f = one - c
    g = one + c
    return EdwardsExtended(spec, e * f, g * h, e * h, f * g)


def double_affine_point(lhs: EdwardsAffine) -> EdwardsExtended:
    """Affine doubling (edwards.rs:28-46). 3M+4S."""
    spec = lhs.spec
    one = spec.field.one()
    x, y = lhs.x, lhs.y
    a = x.square()
    b = y.square()
    c = spec.d * a * b
    h = a + b
    e = (x + y).square() - h
    f = one - c
    g = one + c
    return EdwardsExtended(spec, e * f, g * h, e * h, f * g)


def add_mixed_point(lhs: EdwardsAffine, rhs: EdwardsExtended) -> EdwardsExtended:
    """Affine + extended (edwards.rs:50-70). 10M+4A+2B."""
    spec = lhs.spec
    x0, y0 = lhs.x, lhs.y
    x1, y1, z1, t1 = rhs.x, rhs.y, rhs.z, rhs.t
    a = x0 * x1
    b = y0 * y1
    c = spec.d * x0 * y0 * t1
    h = a + b
    e = (x0 + y0) * (x1 + y1) - h
    f = z1 - c
    g = z1 + c
    return EdwardsExtended(spec, e * f, g * h, e * h, f * g)


def add_projective_point(lhs: EdwardsExtended, rhs: EdwardsExtended) -> EdwardsExtended:
    """Extended + extended (edwards.rs:74-95). 10M+4A+2B. Complete for a=-1."""
    spec = lhs.spec
    x0, y0, z0, t0 = lhs.x, lhs.y, lhs.z, lhs.t
    x1, y1, z1, t1 = rhs.x, rhs.y, rhs.z, rhs.t
    a = x0 * x1
    b = y0 * y1
    c = spec.d * t0 * t1
    d = z0 * z1
    h = a + b
    e = (x0 + y0) * (x1 + y1) - h
    f = d - c
    g = d + c
    return EdwardsExtended(spec, e * f, g * h, e * h, f * g)


def double_projective_point(lhs: EdwardsExtended) -> EdwardsExtended:
    """Extended doubling, a=-1 (edwards.rs:99-116). 4M+3S."""
    spec = lhs.spec
    x, y, z = lhs.x, lhs.y, lhs.z
    a = -x.square()
    b = y.square()
    c = z.square().double()
    d = a - b
    e = (x * y).double()
    g = a + b
    f = g - c
    return EdwardsExtended(spec, e * f, g * d, e * d, f * g)


def scalar_point(point: EdwardsExtended, k: int) -> EdwardsExtended:
    """Double-and-add [k]P (edwards.rs:120-131 semantics)."""
    spec = point.spec
    acc = spec.identity_extended()
    base = point
    k = int(k) % spec.order if spec.order else int(k)
    while k:
        if k & 1:
            acc = add_projective_point(acc, base)
        base = double_projective_point(base)
        k >>= 1
    return acc


JUBJUB_SPEC = EdwardsSpec(
    "Jubjub",
    BlsScalar,
    BlsScalar(C.JUBJUB_D),
    (BlsScalar(C.JUBJUB_GEN[0]), BlsScalar(C.JUBJUB_GEN[1])),
    C.JUBJUB_ORDER,
    C.JUBJUB_COFACTOR,
)
