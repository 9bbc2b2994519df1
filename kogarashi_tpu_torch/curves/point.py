"""Generic batched short-Weierstrass point ops (y^2 = x^3 + b, a = 0) for
G1, G2 and Grumpkin.

Counterpart of `kogarashi_tpu/curves/point.py`: `identity` :49, `generator`
:54, `is_identity` :60, `pneg` :64, `pselect` :68, `padd` :72, `pdouble` :97,
`scalar_mul` :130, `to_affine` :156, `from_affine` :168, `on_curve` :181. The
coefficient algebras of `kogarashi_tpu/curves/algebra.py` (`BaseAlg`,
`Fq2Alg`) have no module here: `Curve.alg` (`fields.mont.Fp` / `Fp2` on
16-bit halves) is their counterpart for the plain torch math, and
`csrc/field.cuh`'s `Alg1` / `Alg2` inside the kernels.

A batch of points is (X, Y, Z), each a (rows, n) int32 word tensor
(`curves.Curve.rows`); the identity is (0 : 1 : 0). The formulas are the
complete RCB16 ones, so every op is branchless. On the card `padd` is K3
`map_padd` and `pdouble` K4 `map_pdouble` (t = 1), and `scalar_mul` is JAX's
MSB-first double-and-add over 256 bits as 256 x (K4, K3, `torch.where`); on
the CPU the same wrappers run their plain versions (`ops/ec.py`). The
affine conversions and the curve check are plain torch on the tensors'
device, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import torch

from ..devices import resolve
from ..fields import mont
from ..ops import ec
from ..ops.msm import pneg
from . import Curve, to_affine

__all__ = ["identity", "generator", "is_identity", "pneg", "pselect", "padd", "pdouble",
           "scalar_mul", "to_affine", "from_affine", "on_curve", "scalar_bits"]


def identity(curve: Curve, n: int, device=None):
    """n lanes of (0 : 1 : 0) on `device` (None: the card)."""
    return ec.identity_words(curve, (n,), resolve(device))


def generator(curve: Curve, device=None):
    """The generator as one lane (rows, 1), Z = 1, on `device` (None: the card)."""
    device = resolve(device)
    x, y = curve.generator_words()
    one = curve.encode_coords([[1] + [0] * (curve.ext - 1)])
    return tuple(torch.from_numpy(c.reshape(curve.rows, 1).copy()).to(device) for c in (x, y, one))


def is_identity(curve: Curve, p):
    """(n,) bool: Z == 0."""
    return (p[2] == 0).all(dim=0)


def pselect(cond, p, q):
    """Lanes of p where cond, else of q."""
    return tuple(torch.where(cond, a, b) for a, b in zip(p, q))


def padd(curve: Curve, p, q):
    """Complete projective add (RCB16 Alg 7): K3."""
    return ec.map_padd(curve, p, q)


def pdouble(curve: Curve, p):
    """Complete projective doubling (RCB16 Alg 9): K4 with t = 1."""
    return ec.map_pdouble(curve, p, times=1)


def scalar_bits(k):
    """(16, n) standard-form 16-bit limbs -> (256, n) bool bits, MSB first."""
    shifts = torch.arange(15, -1, -1, device=k.device, dtype=k.dtype)
    return ((k.flip(0).unsqueeze(1) >> shifts.view(1, 16, 1)) & 1).reshape(256, -1).bool()


def scalar_mul(curve: Curve, p, k):
    """[k]P per lane. p: (rows, n) or one point (rows, 1), broadcast over
    the lanes; k: (16, n) int32 standard-form 16-bit limbs, any 256-bit
    value. MSB-first double-and-add over all 256 bits; the add is always
    computed and the bit selects, as in the JAX package."""
    n = k.shape[1]
    if p[0].shape[1] != n:
        p = tuple(c.expand(curve.rows, n).contiguous() for c in p)
    acc = ec.identity_words(curve, (n,), k.device)
    for bit in scalar_bits(k):
        acc = pdouble(curve, acc)
        acc = pselect(bit, padd(curve, acc, p), acc)
    return acc


def from_affine(curve: Curve, ax, ay, inf):
    """Affine words and an identity mask -> projective; the identity lanes
    become (0 : 1 : 0)."""
    ident = ec.identity_words(curve, (ax.shape[1],), ax.device)
    one = ident[1]
    return pselect(inf, ident, (ax, ay, one))


def on_curve(curve: Curve, p):
    """(n,) bool: Y^2 Z == X^3 + b Z^3, or the identity."""
    A = curve.alg
    x, y, z = (mont.to_halves(c) for c in p)
    b = A.const(_b(curve), x.shape[1:], x.device)
    lhs = A.mul(A.sqr(y), z)
    rhs = A.add(A.mul(A.sqr(x), x), A.mul(A.mul(A.sqr(z), z), b))
    return (lhs == rhs).all(dim=0) | is_identity(curve, p)


def _b(curve: Curve):
    """b = b3 / 3, standard form."""
    p = curve.spec.p
    inv3 = pow(3, -1, p)
    if curve.ext == 1:
        return curve.b3 * inv3 % p
    return tuple(c * inv3 % p for c in curve.b3)
