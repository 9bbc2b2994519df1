"""Windowed fixed-base batch scalar multiplication on the map_padd kernel.

Counterpart of `kogarashi_tpu/ops/fixed_base.py` (`FixedBaseTable` :28,
`fixed_base_mul` :94). The base is the curve generator, so a table
T[w][d] = d * 2^(c w) * G is built once on the host from pyref (one shared
inversion, as at :36-56), and

    [k] G = sum_w T[w][digit_w(k)]

is W - 1 batched complete adds (`ec.map_padd`, K3) over gathered table
entries. No chunking: at 2^20 scalars the live buffers are a few hundred MB.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from ..curves import CURVES, Curve, prepare_points
from ..pyref.curve import ProjectivePoint, batch_to_affine
from . import ec


class FixedBaseTable:
    """The table lives on `device` (None: the card)."""

    def __init__(self, curve: Curve, c: int = 8, bits: int = 256, device=None):
        assert 1 <= c <= 16
        self.curve = curve
        self.c = c
        self.n_windows = -(-bits // c)
        spec = curve.pyref_spec
        g = spec.generator
        base = ProjectivePoint(spec, g.x, g.y, spec.field_one())
        entries = []
        for _ in range(self.n_windows):
            acc = spec.identity_projective()
            entries.append(acc)  # d = 0: masked to the identity at lookup
            for _ in range(1, 1 << c):
                acc = acc + base
                entries.append(acc)
            for _ in range(c):
                base = base.double()
        self.x, self.y, _ = prepare_points(curve, batch_to_affine(entries), device)

    def mul(self, std_scalars):
        """[k_i] G for (16, n) standard-form 16-bit limbs -> (X, Y, Z) words."""
        curve, c = self.curve, self.c
        s = std_scalars.to(torch.int64)
        n = s.shape[-1]
        s = torch.cat([s, torch.zeros((1, n), dtype=torch.int64, device=s.device)])
        ident = ec.identity_words(curve, (n,), s.device)
        one = ident[1]
        acc = None
        for w in range(self.n_windows):
            limb, shift = divmod(w * c, 16)
            raw = (s[limb] | (s[limb + 1] << 16)) >> shift
            d = raw & ((1 << c) - 1)
            idx = d + (w << c)
            zero = (d == 0)[None]
            pt = (torch.where(zero, ident[0], self.x[:, idx]),
                  torch.where(zero, ident[1], self.y[:, idx]),
                  torch.where(zero, ident[2], one))
            acc = pt if acc is None else ec.map_padd(curve, acc, pt)
        return acc


@lru_cache(maxsize=8)
def _table(curve_name: str, c: int, device: str) -> FixedBaseTable:
    return FixedBaseTable(CURVES[curve_name], c=c, device=device)


def fixed_base_mul(curve: Curve, std_scalars, c: int = 8):
    """[k_i] G over `curve`'s generator for (16, n) standard-form limbs."""
    return _table(curve.name, c, str(std_scalars.device)).mul(std_scalars)
