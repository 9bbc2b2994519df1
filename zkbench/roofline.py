"""The least time one NVIDIA H100 SXM could take for an MSM's nominal work.

A frozen copy of the arithmetic of `kogarashi_tpu_torch/ops/ec.py`
(`MULADD_PER_MUL`, `BASE_MULS`, `bound_ms`), with the SM clock fixed at the
card's published maximum instead of a reading under load, so the yardstick
does not move with the card's clock. The time is the larger of:

- operations: point-adds x Montgomery multiplies per G1 mixed add x 264
  32-bit multiply-adds per multiply, at 64 multiply-adds per SM per clock
  (CUDA C++ Programming Guide, compute capability 9.0) on 132 SMs at
  1980 MHz (the H100 SXM data sheet);
- bytes: each base and scalar read once and the result written once, at
  3.35 TB/s (HBM3, the H100 SXM data sheet).
"""

from __future__ import annotations

MULADD_PER_MUL = 264  # csrc/field.cuh's 8x32-bit Montgomery multiply
MULS_PER_G1_MADD = 11  # the complete mixed-add formulas for a = 0, b3 as adds
MULADD_PER_SM_CLOCK = 64
SMS = 132
SM_CLOCK_HZ = 1.98e9
BYTES_PER_S = 3.35e12


def g1_msm_bytes(n: int) -> int:
    """Affine bases (two 8-word coordinates), 32-byte scalars, and a
    three-coordinate projective result."""
    return n * (2 * 8 * 4 + 32) + 3 * 8 * 4


def msm_bound_s(point_adds: float, io_bytes: float) -> float:
    t_ops = point_adds * MULS_PER_G1_MADD * MULADD_PER_MUL / (SMS * MULADD_PER_SM_CLOCK * SM_CLOCK_HZ)
    return max(t_ops, io_bytes / BYTES_PER_S)
