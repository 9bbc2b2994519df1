"""Batched twisted-Edwards (a = -1) point ops and the Jubjub instance.

Counterpart of `kogarashi_tpu/curves/edwards.py`: `identity` :45,
`is_identity` :62, `eneg` :67, `eadd` :77, `edouble` :96, `scalar_mul`
:110, `to_affine` :129, `from_affine` :137, `on_curve` :142, `EdwardsCurve`
:156 (its encode/decode) and `JUBJUB` :196.

Points are (X, Y, T, Z), each an (8, n) int32 word tensor in Montgomery form
over BLS12-381's scalar field (`fields.spec.BLS_FR`); the identity is
(0 : 1 : 0 : 1). The unified formulas are complete (d is a non-square), so
every op is branchless. On the card `eadd` is E2 (`eneg` of its second
operand folded in by `neg=True`), `edouble` E3 and `scalar_mul` E1
(`csrc/edwards.cu`, through `ops/edwards.py`); on the CPU the same wrappers
run their plain versions. `eneg`, the identity test, the affine conversions
and the curve check are plain torch on the tensors' device.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import constants as C
from ..devices import resolve
from ..fields import mont
from ..fields.spec import BLS_FR, FieldSpec
from ..ops import edwards as E
from ..pyref.edwards import JUBJUB_SPEC, EdwardsAffine


@dataclass(frozen=True)
class EdwardsCurve:
    name: str  # selects the kernel instantiation
    spec: FieldSpec  # base field
    d: int  # curve constant, standard form
    order: int  # prime-order subgroup size
    pyref_spec: object  # its generator and cofactor

    rows = 8  # words of a coordinate

    @property
    def alg(self):
        """Plain-torch base field on 16-bit halves (`fields.mont.Fp`)."""
        return mont.field(self.spec)

    def encode_points(self, pts, device=None):
        """pyref EdwardsAffine points -> (X, Y, T, Z) words on `device`
        (None: the card): (x, y, x y, 1)."""
        device = resolve(device)
        p = self.spec.p
        xs = [q.x.v for q in pts]
        ys = [q.y.v for q in pts]
        cols = (xs, ys, [x * y % p for x, y in zip(xs, ys)], [1] * len(pts))
        return tuple(torch.from_numpy(self.spec.encode(c)).to(device) for c in cols)

    def decode_points(self, pt) -> list:
        """(X, Y, T, Z) words -> pyref EdwardsAffine points (host math)."""
        X, Y, _, Z = (self.spec.decode(c.cpu().numpy()) for c in pt)
        p, F = self.spec.p, self.pyref_spec.field
        out = []
        for x, y, z in zip(X, Y, Z):
            zi = pow(z, -1, p) if z else 0
            out.append(EdwardsAffine(self.pyref_spec, F(x * zi), F(y * zi)))
        return out


JUBJUB = EdwardsCurve("jubjub", BLS_FR, C.JUBJUB_D, C.JUBJUB_ORDER, JUBJUB_SPEC)


def identity(curve: EdwardsCurve, n: int, device=None):
    """n lanes of (0 : 1 : 0 : 1) on `device` (None: the card)."""
    device = resolve(device)
    zero = torch.zeros((8, n), dtype=torch.int32, device=device)
    one = torch.from_numpy(curve.spec.encode([1])).to(device).expand(8, n).contiguous()
    return (zero, one, zero.clone(), one.clone())


def generator(curve: EdwardsCurve, device=None):
    """The generator as one lane (8, 1) of each coordinate on `device`
    (None: the card)."""
    return curve.encode_points([curve.pyref_spec.generator], device)


def is_identity(curve: EdwardsCurve, p):
    """(n,) bool: X == 0 and Y == Z."""
    return (p[0] == 0).all(dim=0) & (p[1] == p[3]).all(dim=0)


def eneg(curve: EdwardsCurve, p):
    """-(X : Y : T : Z) = (-X : Y : -T : Z)."""
    return (mont.neg(p[0], spec=curve.spec), p[1], mont.neg(p[2], spec=curve.spec), p[3])


def eadd(curve: EdwardsCurve, p, q, neg: bool = False):
    """Complete extended add, p + q (p - q when `neg`): E2."""
    return E.map_add(curve, p, q, neg)


def edouble(curve: EdwardsCurve, p, times: int = 1):
    """`times` complete doublings, fused: E3."""
    return E.map_double(curve, p, times)


def scalar_mul(curve: EdwardsCurve, p, k):
    """[k]P per lane, k as (16, n) standard-form 16-bit limbs, any 256-bit
    value; p (8, n) or one point (8, 1) broadcast: E1."""
    return E.scalar_mul(curve, p, k)


def to_affine(curve: EdwardsCurve, p):
    """(X : Y : T : Z) -> (X / Z, Y / Z), one Fermat inversion per lane
    (plain torch). Z is never 0 on the curve."""
    F = curve.alg
    x, y, _, z = (mont.to_halves(c) for c in p)
    zi = F.inv(z)
    return mont.to_words(F.mul(x, zi)), mont.to_words(F.mul(y, zi))


def from_affine(curve: EdwardsCurve, ax, ay):
    """(x, y) words -> (x, y, x y, 1)."""
    n = ax.shape[1]
    one = torch.from_numpy(curve.spec.encode([1])).to(ax.device).expand(8, n).contiguous()
    return (ax, ay, mont.mul(ax, ay, spec=curve.spec), one)


def on_curve(curve: EdwardsCurve, p):
    """(n,) bool: (Y^2 - X^2) Z^2 == Z^4 + d X^2 Y^2 and T Z == X Y."""
    F = curve.alg
    x, y, t, z = (mont.to_halves(c) for c in p)
    d = F.const(curve.d, x.shape[1:], x.device)
    x2, y2, z2 = F.sqr(x), F.sqr(y), F.sqr(z)
    lhs = F.mul(F.sub(y2, x2), z2)
    rhs = F.add(F.sqr(z2), F.mul(d, F.mul(x2, y2)))
    return (lhs == rhs).all(dim=0) & (F.mul(t, z) == F.mul(x, y)).all(dim=0)


__all__ = ["EdwardsCurve", "JUBJUB", "identity", "generator", "is_identity", "eneg", "eadd",
           "edouble", "scalar_mul", "to_affine", "from_affine", "on_curve"]
