"""An MSM over bases of known discrete logs: sum_i s_i (k_i G) = (sum_i s_i k_i) G."""

from __future__ import annotations

import operator

from .ec import G1


def msm_by_dlogs(scalars: list[int], dlogs: list[int], curve=G1, bits: int | None = None):
    """The affine sum (None: identity); `bits` keeps only each scalar's low
    bits (the control: the same MSM at a lower precision)."""
    if bits is not None:
        mask = (1 << bits) - 1
        scalars = [s & mask for s in scalars]
    return curve.mul(sum(map(operator.mul, scalars, dlogs)) % curve.order)
