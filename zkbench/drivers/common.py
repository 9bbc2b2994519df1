"""What the drivers share: the control's precision and the program's points
as plain values."""

from __future__ import annotations

import contextlib

import torch

# The control computes in 240-bit scalars: each 254-bit field element loses
# its top 16-bit window, the precision a Pippenger MSM with one window
# fewer would keep.
CONTROL_BITS = 240


def plain(pt):
    """A pyref affine point of the program -> (x, y, infinity) ints; G2's
    coordinates as (c0, c1) pairs."""
    def coord(v):
        return (v.c0.v, v.c1.v) if hasattr(v, "c0") else v.v
    return coord(pt.x), coord(pt.y), bool(pt.is_infinity)


def affine(pt):
    """(x, y, infinity) -> the reference's affine tuple (None: identity)."""
    return None if pt[2] else (pt[0], pt[1])


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def patched(owner, name, value):
    """Set owner.name to value for the duration."""
    real = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield real
    finally:
        setattr(owner, name, real)
