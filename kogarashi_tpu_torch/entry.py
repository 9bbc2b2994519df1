"""Driver entry points of the port.

Counterpart of `__graft_entry__.py`:
  entry()             (fn, example_args): one MSM forward step over BN254 G1
                      on the port's `ops/msm.py::msm` (K1-K4), the kernel path
                      `bench.py` measures (`__graft_entry__.py:17`).
  dryrun_multichip()  one distributed proving step over n ranks, every result
                      checked against a host oracle (`parallel/dryrun.py`,
                      re-exported; `__graft_entry__.py:40`).
"""

from __future__ import annotations

import random
from functools import partial

import torch

from .curves import G1, prepare_points
from .devices import resolve
from .fields.spec import FR, ints_to_limbs16
from .ops.msm import msm
from .parallel.dryrun import dryrun_multichip

__all__ = ["entry", "oracle", "dryrun_multichip"]

N_POINTS = 128  # `__graft_entry__.py:30`
N_BASES = 16  # distinct bases, tiled (:31)
WINDOW = 8  # c (:36)


def entry(device=None):
    """(fn, example_args) on `device` (None: the card): fn(x, y, inf, scalars)
    = sum_i scalars[i] * P_i as (X, Y, Z) words, fn = `msm` on G1 with c = 8.
    The inputs are `__graft_entry__.py:28-37`'s: random.Random(7), 16 bases
    k * g with k below 2^64, tiled to 128 points, then 128 scalars below 2^254,
    as (16, 128) int32 16-bit limbs."""
    device = resolve(device)
    dk, ks = _draws()
    g = G1.pyref_spec.generator
    base = [k * g for k in dk]
    x, y, inf = prepare_points(G1, (base * -(-N_POINTS // N_BASES))[:N_POINTS], device)
    scalars = torch.from_numpy(ints_to_limbs16(ks)).to(device)
    return partial(msm, G1, c=WINDOW), (x, y, inf, scalars)


def oracle():
    """The pyref point fn(*example_args) equals: (sum_i k_i d_(i mod 16)) g."""
    dk, ks = _draws()
    return (sum(k * dk[i % N_BASES] for i, k in enumerate(ks)) % FR.p) * G1.pyref_spec.generator


def _draws():
    """random.Random(7)'s draws, in `__graft_entry__.py`'s order: the bases'
    discrete logs, then the scalars."""
    rng = random.Random(7)
    dk = [rng.randrange(1, 2**64) for _ in range(N_BASES)]
    return dk, [rng.randrange(2**254) for _ in range(N_POINTS)]
