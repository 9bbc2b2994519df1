"""The three Edwards kernels (E1-E3) and their plain PyTorch versions.

Counterpart of the jitted Edwards ops of `kogarashi_tpu/curves/edwards.py`:
`scalar_mul` :110 (a lax.scan under jax.jit), `eadd` :77 with `eneg` :67,
and `edouble` :96. The JAX package has no Pallas kernel for them; the CUDA
kernels (`csrc/edwards.cu`, instantiated for Jubjub) take the place of the
one device loop XLA compiles. Points are (X, Y, T, Z), each an (8, n) int32
word tensor in Montgomery form, canonical in and out; scalars (16, n) int32
standard-form 16-bit limbs (`fields.spec.ints_to_limbs16`).

Dispatch: a CUDA tensor launches the kernel (and counts the launch in
`LAUNCHES`, and by lane group in `ec.GROUP_LAUNCHES`); a CPU tensor runs the
plain version. There is no fallback from one to the other.
"""

from __future__ import annotations

import torch

from ..fields import mont
from . import _build, ec

KERNELS = ("ed_scalar_mul", "ed_map_add", "ed_map_double")
LAUNCHES: dict = {f"{k}_jubjub": 0 for k in KERNELS}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        ec.GROUP_LAUNCHES.pop(k, None)


# ---------------------------------------------------------------------------
# formulas on 16-bit halves (plain versions), independent products batched
# ---------------------------------------------------------------------------


def eadd_h(curve, p, q):
    """Extended + extended (edwards.rs:74-95): 9 multiplies and one by d."""
    F = curve.alg
    x0, y0, t0, z0 = p
    x1, y1, t1, z1 = q
    s0, s1 = F.add_many([(x0, y0), (x1, y1)])
    aa, bb, tt, dd, m = F.mul_many([(x0, x1), (y0, y1), (t0, t1), (z0, z1), (s0, s1)])
    cc = F.mul(F.const(curve.d, tt.shape[1:], tt.device), tt)
    h = F.add(aa, bb)
    e = F.sub(m, h)
    f, g = F.sub(dd, cc), F.add(dd, cc)
    return tuple(F.mul_many([(e, f), (g, h), (e, h), (f, g)]))


def edouble_h(curve, p):
    """Extended doubling, a = -1 (edwards.rs:99-116): 3 squares, 5 multiplies."""
    F = curve.alg
    x, y, _, z = p
    xx, bb, zz, xy = F.mul_many([(x, x), (y, y), (z, z), (x, y)])
    aa = F.neg(xx)
    cc, e = F.add_many([(zz, zz), (xy, xy)])
    dd, g = F.sub(aa, bb), F.add(aa, bb)
    f = F.sub(g, cc)
    return tuple(F.mul_many([(e, f), (g, dd), (e, dd), (f, g)]))


def _h(ts):
    return tuple(mont.to_halves(t) for t in ts)


def _w(ts):
    return tuple(mont.to_words(t) for t in ts)


def scalar_mul_plain(curve, p, k):
    n = k.shape[1]
    base = tuple(c.expand(16, n) for c in _h(p))
    F = curve.alg
    acc = (F.zero((n,), k.device), F.one((n,), k.device), F.zero((n,), k.device), F.one((n,), k.device))
    for j in range(255, -1, -1):
        bit = ((k[j // 16] >> (j % 16)) & 1).bool()
        acc = edouble_h(curve, acc)
        s = eadd_h(curve, acc, base)
        acc = tuple(torch.where(bit, a, b) for a, b in zip(s, acc))
    return _w(acc)


def _neg_xt(curve, q):
    F = curve.alg
    x, y, t, z = q
    return (F.neg(x), y, F.neg(t), z)


def map_add_plain(curve, p, q, neg: bool = False):
    qh = _h(q)
    return _w(eadd_h(curve, _h(p), _neg_xt(curve, qh) if neg else qh))


def map_double_plain(curve, p, times: int = 1):
    ph = _h(p)
    for _ in range(times):
        ph = edouble_h(curve, ph)
    return _w(ph)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _launch(kernel: str, curve, ptrs, *ints, group: int | None = None):
    """One launch of kernel_curve; `group`: the lane group, passed after the
    other ints and counted in `ec.GROUP_LAUNCHES`."""
    key = f"{kernel}_{curve.name}"
    if group is not None:
        ints += (group,)
    with torch.cuda.device(ptrs[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in ptrs]
        rc = getattr(_build.lib(), f"kt_{key}")(*args, *ints, stream)
    _build.check(rc, key)
    ec._count(LAUNCHES, key, group)


def _empty4(like, n: int):
    return tuple(torch.empty((8, n), dtype=torch.int32, device=like.device) for _ in range(4))


def scalar_mul(curve, p, k, group: int | None = None):
    """E1. [k]P per lane: p (X, Y, T, Z) of (8, n), or one point (8, 1)
    broadcast over the lanes; k (16, n) int32 standard-form 16-bit limbs.
    `group`: threads per lane, by default `ec.lane_group`'s."""
    on_card = ec._check(curve, p, 2)
    if k.dtype != torch.int32 or k.dim() != 2 or k.shape[0] != 16 or not k.is_contiguous():
        raise ValueError(f"expected (16, n) contiguous int32 scalar limbs, got {k.dtype} {tuple(k.shape)}")
    if k.device != p[0].device:
        raise ValueError("points and scalars must share one device")
    n, pn = k.shape[1], p[0].shape[1]
    if pn not in (1, n):
        raise ValueError(f"{pn} base lanes for {n} scalars")
    g = ec._group("ed_scalar_mul", curve, n, group)
    if not on_card:
        return scalar_mul_plain(curve, p, k)
    out = _empty4(k, n)
    if n:
        _launch("ed_scalar_mul", curve, (*p, pn, k, *out), n, group=g)
    return out


def map_add(curve, p, q, neg: bool = False, group: int | None = None):
    """E2. Pointwise p + q, or p - q when `neg`; (8, n) each. `group`:
    threads per lane, by default `ec.lane_group`'s."""
    on_card = ec._check(curve, (*p, *q), 2)
    n = p[0].shape[1]
    g = ec._group("ed_map_add", curve, n, group)
    if not on_card:
        return map_add_plain(curve, p, q, neg)
    out = _empty4(p[0], n)
    if n:
        _launch("ed_map_add", curve, (*p, *q, *out), n, int(neg), group=g)
    return out


def map_double(curve, p, times: int = 1, group: int | None = None):
    """E3. `times` doublings in a row, fused; (8, n). `group`: threads per
    lane, by default `ec.lane_group`'s."""
    on_card = ec._check(curve, p, 2)
    n = p[0].shape[1]
    g = ec._group("ed_map_double", curve, n, group)
    if not on_card:
        return map_double_plain(curve, p, times)
    out = _empty4(p[0], n)
    if n:
        _launch("ed_map_double", curve, (*p, *out), n, times, group=g)
    return out


# ---------------------------------------------------------------------------
# the least time the card could take for a kernel call (chip_smoke.py)
# ---------------------------------------------------------------------------

# Montgomery multiplies the work needs: E1 per lane (d T_P once; 256 bits x
# (edouble 8 + the add of the fixed base 8); the last add's T, as no doubling
# reads T), E2 per add (9 and the multiply by d), E3 per doubling 7 (3
# squares, 4 multiplies) and the last doubling's T once (`bound_ms`)
MULS = {"ed_scalar_mul": 256 * 16 + 2, "ed_map_add": 10, "ed_map_double": 7}
# dependent multiply levels of one ladder bit (E1): edouble 2 (x^2, y^2, z^2,
# x y; the four outputs), the add of the fixed base 2 (its five products; the
# four outputs); of one E2 add, 3 (the five products, the multiply by d, the
# four outputs); of one E3 doubling, 2 (x^2, y^2, z^2, x y; the outputs).
# The critical-path floors chip_smoke.py logs (`floor_ms`).
LADDER_LEVELS = 4
ADD_LEVELS = 3
DOUBLE_LEVELS = 2


def floor_ms(kernel: str, mul_cycles: float, sm_clock_hz: float, launch_ms: float, times: int = 1):
    """A lane's critical-path floor: its dependent levels (E1: LADDER_LEVELS
    a bit over 256 bits; E2: ADD_LEVELS; E3: DOUBLE_LEVELS a doubling over
    `times`), each at least one dependent multiply of `mul_cycles`, plus an
    empty launch."""
    levels = {"ed_scalar_mul": LADDER_LEVELS * 256, "ed_map_add": ADD_LEVELS,
              "ed_map_double": DOUBLE_LEVELS * times}[kernel]
    return levels * mul_cycles / sm_clock_hz * 1e3 + launch_ms


def bound_ms(kernel: str, n: int, sm_clock_hz: float, times: int = 1, base_lanes: int | None = None):
    """(ms, "operations" | "bytes"): the larger of the time for the 32-bit
    multiply-adds (ec.MULADD_PER_MUL per multiply at 64 per SM per clock on
    132 SMs) and the time to read each input and write each output once at
    3.35 TB/s, for one call over n lanes (E1: `base_lanes` base points, 1 or
    n; E3: `times` doublings)."""
    muls = n * (MULS[kernel] * times + 1 if kernel == "ed_map_double" else MULS[kernel])
    t_ops = muls * ec.MULADD_PER_MUL / (ec.H100_SMS * ec.MULADD_PER_SM_CLOCK * sm_clock_hz) * 1e3
    point = 4 * 8 * 4  # bytes of one extended point
    in_bytes = {"ed_scalar_mul": (base_lanes or n) * point + n * 16 * 4,
                "ed_map_add": 2 * n * point, "ed_map_double": n * point}[kernel]
    t_bytes = (in_bytes + n * point) / ec.H100_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
