"""BN254 G1 and G2, and Grumpkin, for the port: constants, host
encode/decode, batched projective-to-affine.

Counterpart of `kogarashi_tpu/curves/__init__.py` (`Curve` :23, its
instances `_mk_curves` :88-124), `ec_pallas.CurveK` (:170) and
`msm_pallas.curve_k` (:473). `encode_projective` and `decode_points` are the
counterparts of `Curve.encode_points` (:52) and `Curve.decode_points` (:71).
A batch of points is a tuple of word tensors (X, Y, Z), each (rows, ...)
with rows = 8 * ext; affine batches are (x, y, inf). The identity is
(0 : 1 : 0). The batched point ops (`padd`, `pdouble`, `scalar_mul`, ...)
are in `curves.point`, Jubjub's in `curves.edwards`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import constants as C
from ..devices import resolve
from ..fields import mont
from ..fields.spec import FQ, FR, FieldSpec
from ..pyref import G1_SPEC, G2_SPEC, GRUMPKIN_SPEC, Fq, Fq2


@dataclass(frozen=True)
class Curve:
    name: str  # "g1" | "g2" | "grumpkin": selects the kernel instantiation
    ext: int  # 1: coordinates in the base field, 2: in Fq2
    spec: FieldSpec  # base field
    b3: object  # 3b, standard form: int (ext 1) or (c0, c1)
    pyref_spec: object

    @property
    def rows(self) -> int:
        return 8 * self.ext

    @property
    def alg(self):
        """Plain-torch algebra on 16-bit halves (`fields.mont.Fp`/`Fp2`)."""
        return mont.field(self.spec, self.ext)

    def b3_halves(self, shape, device):
        return self.alg.const(self.b3, shape, device)

    def comps(self, v) -> list[int]:
        """pyref coordinate -> standard-form int components."""
        return [v.v] if self.ext == 1 else [v.c0.v, v.c1.v]

    def encode_coords(self, vals) -> np.ndarray:
        """Per-point component lists -> (rows, n) Montgomery words."""
        cols = [self.spec.encode([c[e] for c in vals]) for e in range(self.ext)]
        return np.concatenate(cols, axis=0)

    def decode_coords(self, arr) -> list:
        """(rows, n) Montgomery words -> pyref coordinates."""
        a = np.asarray(arr)
        comps = [self.spec.decode(a[8 * e : 8 * e + 8]) for e in range(self.ext)]
        if self.ext == 1:
            return [self.pyref_spec.field(v) for v in comps[0]]
        return [Fq2(Fq(a0), Fq(a1)) for a0, a1 in zip(*comps)]

    def generator_words(self):
        """(x, y) of the generator as (rows,) int32 numpy words."""
        g = self.pyref_spec.generator
        x = self.encode_coords([self.comps(g.x)])[:, 0]
        y = self.encode_coords([self.comps(g.y)])[:, 0]
        return x, y


G1 = Curve("g1", 1, FQ, 3 * C.G1_B % C.Q, G1_SPEC)
G2 = Curve("g2", 2, FQ, (3 * C.G2_B[0] % C.Q, 3 * C.G2_B[1] % C.Q), G2_SPEC)
# y^2 = x^3 - 17 over Fr, the commitment curve of Nova's secondary circuit
GRUMPKIN = Curve("grumpkin", 1, FR, 3 * C.GRUMPKIN_B % C.R, GRUMPKIN_SPEC)
CURVES = {"g1": G1, "g2": G2, "grumpkin": GRUMPKIN}


def prepare_points(curve: Curve, pts, device=None):
    """pyref affine points -> (x, y, inf): (rows, n) int32 Montgomery words
    and an (n,) bool mask on `device` (None: the card). The identity encodes
    as x = y = 0."""
    device = resolve(device)
    zero = [0] * curve.ext
    xs = curve.encode_coords([zero if q.is_infinity else curve.comps(q.x) for q in pts])
    ys = curve.encode_coords([zero if q.is_infinity else curve.comps(q.y) for q in pts])
    inf = np.array([q.is_infinity for q in pts], dtype=bool)
    return (torch.from_numpy(xs).to(device), torch.from_numpy(ys).to(device),
            torch.from_numpy(inf).to(device))


def encode_projective(curve: Curve, pts, device=None):
    """pyref affine points -> projective word batch (X, Y, Z) on `device`
    (None: the card), identity (0:1:0)."""
    device = resolve(device)
    zero, one = [0] * curve.ext, [1] + [0] * (curve.ext - 1)
    out = []
    for coord in ("x", "y", "z"):
        vals = []
        for q in pts:
            if coord == "z":
                vals.append(zero if q.is_infinity else one)
            elif q.is_infinity:
                vals.append(one if coord == "y" else zero)
            else:
                vals.append(curve.comps(getattr(q, coord)))
        out.append(torch.from_numpy(curve.encode_coords(vals)).to(device))
    return tuple(out)


def decode_points(curve: Curve, pt) -> list:
    """Projective word batch (X, Y, Z) -> pyref affine points (host math)."""
    X, Y, Z = (curve.decode_coords(c.cpu().numpy()) for c in pt)
    spec = curve.pyref_spec
    Aff = type(spec.generator)
    out = []
    for x, y, z in zip(X, Y, Z):
        if z.is_zero():
            out.append(spec.identity_affine())
        else:
            zi = z.invert()
            out.append(Aff(spec, x * zi, y * zi, False))
    return out


def decode_affine(curve: Curve, x, y, inf) -> list:
    """Affine word batch -> pyref affine points."""
    X = curve.decode_coords(x.cpu().numpy())
    Y = curve.decode_coords(y.cpu().numpy())
    spec = curve.pyref_spec
    Aff = type(spec.generator)
    flags = inf.cpu().numpy()
    return [spec.identity_affine() if f else Aff(spec, a, b, False)
            for a, b, f in zip(X, Y, flags)]


def to_affine(curve: Curve, pt):
    """Batched projective -> affine on the tensors' device: one Fermat
    inversion per lane (plain torch). Returns (x, y, inf); the identity
    gives x = y = 0, inf = True."""
    A = curve.alg
    X, Y, Z = (mont.to_halves(c) for c in pt)
    zi = A.inv(Z)
    return (mont.to_words(A.mul(X, zi)), mont.to_words(A.mul(Y, zi)), A.is_zero(Z))

