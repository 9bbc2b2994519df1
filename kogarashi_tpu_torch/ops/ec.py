"""The four point kernels (K1-K4) and their plain PyTorch versions.

Counterpart of `kogarashi_tpu/ops/ec_pallas.py`: `madd` :218, `padd` :241,
`pdouble` :264 (RCB16 Alg 8/7/9, a = 0, identity (0:1:0)), and the kernels
`scan_mixed` :416, `scan_proj` :427, `map_padd` :479, `map_pdouble` :487.
The CUDA kernels are in `csrc/ec.cu`, instantiated for G1 (Fq), G2 (Fq2)
and Grumpkin (Fr).

Shapes follow the JAX package: scans take (rows, L, C) word tensors and
return the inclusive per-chunk prefix sums S[:, j, c] = sum of chunk c's
elements 0..j; maps take (rows, C). rows = 8 (G1, Grumpkin) or 16 (G2);
int32 words in Montgomery form, canonical in and out.

Dispatch: a CUDA tensor launches the kernel (and counts the launch in
`LAUNCHES`, K2's and K4's also by lane group in `GROUP_LAUNCHES`); a CPU
tensor runs the plain version. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import time

import torch

from ..curves import Curve
from ..fields import mont
from . import _build

KERNELS = ("scan_mixed", "scan_proj", "map_padd", "map_pdouble")
LAUNCHES: dict = {f"{k}_{c}": 0 for k in KERNELS for c in ("g1", "g2", "grumpkin")}
GROUP_LAUNCHES: dict = {}  # "scan_proj_g1" -> {g: launches}, K2 and K4


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    GROUP_LAUNCHES.clear()


# ---------------------------------------------------------------------------
# formulas on 16-bit halves, generic over the algebra (plain versions)
# ---------------------------------------------------------------------------


def identity(curve: Curve, shape, device):
    A = curve.alg
    return (A.zero(shape, device), A.one(shape, device), A.zero(shape, device))


def identity_words(curve: Curve, shape, device):
    """The identity (0 : 1 : 0) as a word batch of `shape`."""
    return _w(identity(curve, tuple(shape), device))


# Independent field operations are batched into one call (`*_many`): the
# same canonical results in a third as many torch ops.


def padd_h(curve: Curve, p, q):
    """RCB16 Alg 7, a = 0."""
    A = curve.alg
    b3 = curve.b3_halves(p[0].shape[1:], p[0].device)
    x1, y1, z1 = p
    x2, y2, z2 = q
    s1, s2, s3, s4, s5, s6 = A.add_many([(x1, y1), (x2, y2), (y1, z1), (y2, z2), (x1, z1), (x2, z2)])
    t0, t1, t2, u3, u4, u5 = A.mul_many([(x1, x2), (y1, y2), (z1, z2), (s1, s2), (s3, s4), (s5, s6)])
    v3, v4, v5 = A.sub_many([(u3, t0), (u4, t1), (u5, t0)])
    t3, t4, t5 = A.sub_many([(v3, t1), (v4, t2), (v5, t2)])
    t6 = A.add(A.add(t0, t0), t0)
    t2b3, y5 = A.mul_many([(t2, b3), (t5, b3)])
    zz, tt = A.add(t1, t2b3), A.sub(t1, t2b3)
    m1, m2, m3, m4, m5, m6 = A.mul_many([(t3, tt), (t4, y5), (y5, t6), (tt, zz), (zz, t4), (t6, t3)])
    x3 = A.sub(m1, m2)
    y3, z3 = A.add_many([(m3, m4), (m5, m6)])
    return (x3, y3, z3)


def madd_h(curve: Curve, p, x2, y2):
    """RCB16 Alg 8, a = 0: projective p + affine (x2, y2)."""
    A = curve.alg
    b3 = curve.b3_halves(p[0].shape[1:], p[0].device)
    x1, y1, z1 = p
    s1, s2 = A.add_many([(x2, y2), (x1, y1)])
    t0, t1, u3, u4, u5, t2 = A.mul_many([(x1, x2), (y1, y2), (s1, s2), (y2, z1), (x2, z1), (b3, z1)])
    t3 = A.sub(A.sub(u3, t0), t1)
    t4, t5 = A.add_many([(u4, y1), (u5, x1)])
    t6 = A.add(A.add(t0, t0), t0)
    zz, tt = A.add(t1, t2), A.sub(t1, t2)
    y5 = A.mul(b3, t5)
    m1, m2, m3, m4, m5, m6 = A.mul_many([(t3, tt), (t4, y5), (y5, t6), (tt, zz), (zz, t4), (t6, t3)])
    x3 = A.sub(m1, m2)
    y3, z3 = A.add_many([(m3, m4), (m5, m6)])
    return (x3, y3, z3)


def pdouble_h(curve: Curve, p):
    """RCB16 Alg 9, a = 0."""
    A = curve.alg
    b3 = curve.b3_halves(p[0].shape[1:], p[0].device)
    x, y, z = p
    t0, t1, zsq, xy = A.mul_many([(y, y), (y, z), (z, z), (x, y)])
    t2 = A.mul(zsq, b3)
    z8 = A.add(t0, t0)
    z8 = A.add(z8, z8)
    z8 = A.add(z8, z8)  # 8 y^2
    x3, z3 = A.mul_many([(t2, z8), (t1, z8)])
    y3, t2x2 = A.add_many([(t0, t2), (t2, t2)])
    t0 = A.sub(t0, A.add(t2x2, t2))
    u, xf = A.mul_many([(t0, y3), (t0, xy)])
    y3, x3 = A.add_many([(u, x3), (xf, xf)])
    return (x3, y3, z3)


def _h(ts):
    return tuple(mont.to_halves(t) for t in ts)


def _w(ts):
    return tuple(mont.to_words(t) for t in ts)


def scan_mixed_plain(curve: Curve, x, y):
    rows, L, C = x.shape
    xh, yh = mont.to_halves(x), mont.to_halves(y)
    acc = identity(curve, (C,), x.device)
    out = [[], [], []]
    for j in range(L):
        acc = madd_h(curve, acc, xh[:, j], yh[:, j])
        for o, a in zip(out, acc):
            o.append(a)
    return tuple(mont.to_words(torch.stack(o, dim=1)) for o in out)


def scan_proj_plain(curve: Curve, x, y, z):
    rows, L, C = x.shape
    ph = _h((x, y, z))
    acc = identity(curve, (C,), x.device)
    out = [[], [], []]
    for j in range(L):
        acc = padd_h(curve, acc, tuple(c[:, j] for c in ph))
        for o, a in zip(out, acc):
            o.append(a)
    return tuple(mont.to_words(torch.stack(o, dim=1)) for o in out)


def map_padd_plain(curve: Curve, p, q):
    return _w(padd_h(curve, _h(p), _h(q)))


def map_pdouble_plain(curve: Curve, p, times: int = 1):
    ph = _h(p)
    for _ in range(times):
        ph = pdouble_h(curve, ph)
    return _w(ph)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check(curve: Curve, ts, ndim: int):
    dev = ts[0].device
    shape = ts[0].shape
    if len(shape) != ndim or shape[0] != curve.rows:
        raise ValueError(f"{curve.name}: expected {ndim}-d ({curve.rows}, ...) words, got {tuple(shape)}")
    for t in ts:
        if t.dtype != torch.int32:
            raise TypeError(f"expected int32 words, got {t.dtype}")
        if t.device != dev or t.shape != shape:
            raise ValueError("all coordinates must share one device and shape")
        if not t.is_contiguous():
            raise ValueError("coordinates must be contiguous")
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"unsupported device {dev}")


# ---------------------------------------------------------------------------
# lane groups (csrc/ec.cu): K2 and K4 spread one lane's point op over g
# threads of a warp where one thread per lane would leave the card idle
# ---------------------------------------------------------------------------

# (kernel, curve) -> ((C at least, g), ...): a launch over C lanes takes the g
# of the first row whose bound C meets. The rows come from timing every g at
# each shape of the main path on an H100 (`profile_lanes.py`, PERF.md); each
# g named here is built in csrc/ec.cu, and no other (1: the one-thread kernel).
# Grumpkin builds G1's sizes; its K2 rows come from its own shapes, those of
# one Nova secondary commit (78982 points).
LANE_GROUPS = {
    ("scan_proj", "g1"): ((32768, 1), (8192, 2), (4096, 4), (0, 8)),
    ("scan_proj", "g2"): ((16384, 1), (2048, 8), (0, 16)),
    ("scan_proj", "grumpkin"): ((32768, 1), (4944, 2), (2480, 4), (0, 8)),
    ("map_pdouble", "g1"): ((8192, 1), (0, 4)),
    ("map_pdouble", "g2"): ((8192, 1), (0, 16)),
    ("map_pdouble", "grumpkin"): ((8192, 1), (0, 4)),
}


def groups(kernel: str, curve: Curve) -> tuple:
    """The group sizes built for a kernel and curve, smallest first."""
    return tuple(sorted(g for _, g in LANE_GROUPS[(kernel, curve.name)]))


def lane_group(kernel: str, curve: Curve, C: int) -> int:
    """Threads per lane for a K2 or K4 launch over C lanes (LANE_GROUPS)."""
    return next(g for least, g in LANE_GROUPS[(kernel, curve.name)] if C >= least)


def _group(kernel: str, curve: Curve, C: int, group):
    g = lane_group(kernel, curve, C) if group is None else group
    if g not in groups(kernel, curve):
        raise ValueError(f"{kernel}_{curve.name}: no lane group of {g} threads "
                         f"(built: {groups(kernel, curve)})")
    return g


def _launch(kernel: str, curve: Curve, ins, outs, *ints, group: int | None = None):
    """One launch of kernel_curve; `group`: K2's and K4's lane group, passed
    after the other ints and counted in GROUP_LAUNCHES."""
    key = f"{kernel}_{curve.name}"
    if group is not None:
        ints += (group,)
    with torch.cuda.device(ins[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        fn = getattr(_build.lib(), f"kt_{key}")
        rc = fn(*[t.data_ptr() for t in ins], *[t.data_ptr() for t in outs], *ints, stream)
    _build.check(rc, key)
    LAUNCHES[key] += 1
    if group is not None:
        by = GROUP_LAUNCHES.setdefault(key, {})
        by[group] = by.get(group, 0) + 1


def _empty3(like):
    return tuple(torch.empty_like(like) for _ in range(3))


def scan_mixed(curve: Curve, x, y):
    """K1. x, y: (rows, L, C) canonical affine words -> (Sx, Sy, Sz)."""
    if not _check(curve, (x, y), 3):
        return scan_mixed_plain(curve, x, y)
    _, L, C = x.shape
    out = _empty3(x)
    if L * C:
        _launch("scan_mixed", curve, (x, y), out, L, C)
    return out


def scan_proj(curve: Curve, x, y, z, group: int | None = None):
    """K2. Per-chunk inclusive scan of projective adds; (rows, L, C) each.
    `group`: threads per lane, by default `lane_group`'s."""
    on_card = _check(curve, (x, y, z), 3)
    rows, L, C = x.shape
    if rows * L * C >= 1 << 32:
        raise ValueError(f"scan_proj: {tuple(x.shape)} has 2^32 words or more (32-bit word offsets)")
    g = _group("scan_proj", curve, C, group)
    if not on_card:
        return scan_proj_plain(curve, x, y, z)
    out = _empty3(x)
    if L * C:
        _launch("scan_proj", curve, (x, y, z), out, L, C, group=g)
    return out


def map_padd(curve: Curve, p, q):
    """K3. Pointwise complete add of two (rows, C) projective batches."""
    if not _check(curve, (*p, *q), 2):
        return map_padd_plain(curve, p, q)
    C = p[0].shape[1]
    out = _empty3(p[0])
    if C:
        _launch("map_padd", curve, (*p, *q), out, C)
    return out


def map_pdouble(curve: Curve, p, times: int = 1, group: int | None = None):
    """K4. `times` doublings in a row, fused in one kernel; (rows, C).
    `group`: threads per lane, by default `lane_group`'s."""
    on_card = _check(curve, p, 2)
    C = p[0].shape[1]
    g = _group("map_pdouble", curve, C, group)
    if not on_card:
        return map_pdouble_plain(curve, p, times)
    out = _empty3(p[0])
    if C:
        _launch("map_pdouble", curve, p, out, C, times, group=g)
    return out


# ---------------------------------------------------------------------------
# the least time the card could take for a kernel call (chip_smoke.py)
# ---------------------------------------------------------------------------

# csrc/field.cuh's multiply is 264 32-bit integer multiply-adds (PTX mad.lo /
# mad.hi): 8 rows of 4 chains of 8, and the 8 digits m_i. ptxas fuses each
# lo/hi pair of a chain into one IMAD.WIDE, which yields both.
MULADD_PER_MUL = 264
# Montgomery multiplies per point op, as csrc/ec.cu does them: G1's and
# Grumpkin's b3 products are adds; G2's are Fq2 multiplies (an Fq2 mul is 3,
# a square 2)
BASE_MULS = {
    ("madd", "g1"): 11, ("padd", "g1"): 12, ("pdouble", "g1"): 8,
    ("madd", "g2"): 39, ("padd", "g2"): 42, ("pdouble", "g2"): 25,
    ("madd", "grumpkin"): 11, ("padd", "grumpkin"): 12, ("pdouble", "grumpkin"): 8,
}
H100_SMS = 132
# NVIDIA's arithmetic-throughput table (CUDA C++ Programming Guide, compute
# capability 9.0): 64 32-bit integer multiply-adds per SM per clock.
# `issue_rates` checks it on the card (chip_smoke.py logs it every run).
MULADD_PER_SM_CLOCK = 64
H100_BYTES_PER_S = 3.35e12  # HBM3, the H100 SXM data sheet
_WORK = {  # kernel -> (point op, coordinate tensors read)
    "scan_mixed": ("madd", 2), "scan_proj": ("padd", 3),
    "map_padd": ("padd", 6), "map_pdouble": ("pdouble", 3),
}


def bound_ms(kernel: str, curve: Curve, shape, sm_clock_hz: float, times: int = 1):
    """(ms, "operations" | "bytes"): the larger of the time for the 32-bit
    multiply-adds (MULADD_PER_MUL per Montgomery multiply, at 64 per SM per
    clock on 132 SMs) and the time to read each input and write each of the
    three outputs once at 3.35 TB/s, for one call on `shape` ((rows, L, C) or
    (rows, C))."""
    op, n_in = _WORK[kernel]
    lanes = 1
    for s in shape[1:]:
        lanes *= int(s)
    point_ops = lanes * (times if kernel == "map_pdouble" else 1)
    muladds = point_ops * BASE_MULS[(op, curve.name)] * MULADD_PER_MUL
    t_ops = muladds / (H100_SMS * MULADD_PER_SM_CLOCK * sm_clock_hz) * 1e3
    t_bytes = (n_in + 3) * curve.rows * 4 * lanes / H100_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def issue_rates(device, iters: int = 1 << 13) -> dict:
    """Instructions issued per SM per clock by csrc/imad_probe.cu, one full
    wave of independent chains of each (the probe's header says how it
    counts): "imad" (IMAD, one multiply-add) and "imad_wide" (IMAD.WIDE in
    field.cuh's carry chains, two). A check of the rate `bound_ms` assumes,
    not on the prove path."""
    lib = _build.lib()
    rates = {}
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        for mode, name in enumerate(("imad", "imad_wide")):
            info = (ctypes.c_int * 3)()
            _build.check(lib.kt_imad_probe_info(mode, info), "imad_probe_info")
            per_sm, threads, per_round = info
            n = torch.cuda.get_device_properties(device).multi_processor_count * per_sm * threads
            sink = torch.empty(n, dtype=torch.int32, device=device)
            cycles = torch.empty(n, dtype=torch.int64, device=device)
            for _ in range(2):  # the first launch warms up
                rc = lib.kt_imad_probe(mode, iters, n // threads, sink.data_ptr(), cycles.data_ptr(), stream)
                _build.check(rc, "imad_probe")
            rates[name] = per_sm * threads * iters * per_round / int(cycles.max())
    return rates


# dependent multiply levels of one doubling on a lane group (csrc/ec.cu
# `pdouble_group`), for the one-lane critical-path floor chip_smoke.py logs
PDOUBLE_LEVELS = {"g1": 2, "g2": 3, "grumpkin": 2}


def mul_latency_cycles(device, call: bool, iters: int = 4096) -> float:
    """Clock cycles of one Montgomery multiply in a dependent chain on one
    thread (csrc/imad_probe.cu): inline as G1's kernels run it, or through
    G2's non-inlined call. Not on the prove path."""
    sink = torch.empty(1, dtype=torch.int32, device=device)
    cycles = torch.empty(1, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(2):  # the first launch warms up
            rc = _build.lib().kt_mul_latency(int(call), iters, sink.data_ptr(), cycles.data_ptr(), stream)
            _build.check(rc, "mul_latency")
    return int(cycles[0]) / iters


def device_ms(fn, device, reps: int = 20) -> float:
    """Mean device milliseconds of fn() over `reps` calls in a row, between
    two CUDA events, after one warm-up call. csrc/imad_probe.cu's spin kernel
    holds the stream while the host queues the calls behind it (for three
    times the host time that many calls took, plus 5 ms, at most 0.5 s), so
    the device runs them back to back: what is timed is the device's work
    and each launch's gap on the device, not the host's launch overhead.
    Raises if the host still had not queued them all within a second, longer
    spin, as it does when the calls make more launches than the device queues
    (about a thousand): give such an fn fewer reps."""
    lib = _build.lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        spin_s = min(3 * (time.perf_counter() - t0) + 5e-3, 0.5)
        for _ in range(2):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            _build.check(lib.kt_spin(int(spin_s * 2.0e9), stream), "spin")  # cycles at <= 2 GHz
            t0 = time.perf_counter()
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            queued_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            if queued_s < spin_s:
                return start.elapsed_time(end) / reps
            spin_s = min(2 * spin_s, 1.0)
    raise RuntimeError(f"device_ms: the host took {queued_s:.4f} s to queue {reps} calls, past the spin")


def empty_launch_ms(device, reps: int = 200) -> float:
    """Device milliseconds per launch of an empty kernel, launched back to
    back (`device_ms`)."""
    lib = _build.lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
    return device_ms(lambda: _build.check(lib.kt_empty(stream), "empty"), device, reps)


def field_op_cuda(spec_name: str, op: str, a, b):
    """Elementwise field op through csrc/field_check.cu (check kernel, not on
    the prove path). a, b: (8, n) contiguous int32 words on the card."""
    codes = {"mul": 0, "sqr": 1, "add": 2, "sub": 3, "neg": 4}
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        fn = getattr(_build.lib(), f"kt_field_op_{spec_name}")
        rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), codes[op], a.shape[1], stream)
    _build.check(rc, f"field_op_{spec_name}")
    return out
