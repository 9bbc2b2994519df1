"""Micro-benchmark matrix of the port, one op at a time, on one card.

    python -m kogarashi_tpu_torch.benches.microbench [--batch 65536] [--only GROUP] [--device cpu]

Counterpart of `benches/microbench.py` (which times the JAX package; it
mirrors the reference's criterion harnesses bn254/benches/bn_254_{field,
curve}.rs and grumpkin/benches/grumpkin_curve.rs). Prints one JSON line per
op, {"bench", "value", "unit"}, under the original's bench names, the first
one {"bench": "backend", "value": 0, "unit": <the card's name>}. Groups
(`--only`):
  field   Fr and Fq add, sub, mul, square on `batch` lanes and invert on
          batch / 16, on the port's plain field engine (`fields.mont.Fp`,
          the math of the NTT, SpMV and setup on the card)
  curve   add, double, scalar_mul for g1, grumpkin, g2 (batch / 4) on
          `curves.point` (padd = K3, pdouble = K4 t = 1, scalar_mul = 256 x
          K4 and K3) and jubjub on `curves.edwards` (add = E2, double = E3,
          scalar_mul = E1); scalar_mul on max(n / 256, 16) lanes
  msm     a G1 MSM over `batch` points, then the NTT (as the original's msm
          group). The original times the JAX package's all-XLA `msm_jit`,
          which is not ported; its counterpart here is `ops/msm.py::msm`
          (K1-K4), the counterpart of the JAX package's `msm_pallas`
  ntt     `fr_2^k`: `ops/ntt.py::Domain(k).dft`, k = max(10, min(16, log2 batch))
  native  the JAX package's host C++ runtime (`native/`) is not ported, so
          its two lines are the port's counterparts, named without `native/`:
          `spmv` (`ops/spmv.py` on the card, 5 non-zeros a row, n = 2^14) and
          `mimc_absorb` (`pyref/mimc.py`'s sponge fold on the host, 512
          elements)
Inputs follow the original's seeds. Its field inputs are 256 draws of a
fresh random.Random(1), so all one value; here one random.Random(1) stream
gives 256 values.

Before an op is timed, its output on the first 16 lanes is held to its
plain version (the kernel's plain PyTorch version on the same lanes, word
for word) or to host integers (field ops, scalar_mul on g1, grumpkin and g2,
the MSM, the NTT, the SpMV), so a wrong kernel cannot "win". Times are the
median of 3 calls after a warm-up call, each ended by a device
synchronisation. The original copies each output to the host inside its
window because `block_until_ready` was not a reliable clock on its
platform; `torch.cuda.synchronize` is, and a copy would time the transfer.
"""

from __future__ import annotations

import argparse
import json
import random
import statistics
import sys
import time
from functools import partial

import numpy as np
import torch

from ..bench import oracle
from ..curves import G1, G2, GRUMPKIN, decode_points, encode_projective, point, prepare_points
from ..curves import edwards as ed
from ..curves.edwards import JUBJUB
from ..devices import backend_name, resolve, synchronize
from ..fields import mont
from ..fields.spec import FQ, FR, ints_to_limbs16
from ..ops import ec, spmv
from ..ops import edwards as E
from ..ops.msm import default_window, msm
from ..ops.ntt import Domain
from ..pyref import Fr
from ..pyref.mimc import Mimc

CHECK_LANES = 16
GROUPS = ("field", "curve", "msm", "ntt", "native")


def emit(bench: str, value, unit: str) -> None:
    print(json.dumps({"bench": bench, "value": value, "unit": unit}), flush=True)


def timeit(fn, device, reps: int = 3) -> float:
    """Median seconds of fn() over `reps` calls after a warm-up call, each
    call ended by a device synchronisation."""
    fn()
    synchronize(device)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        synchronize(device)
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def _check(name: str, ok: bool) -> None:
    if not ok:
        raise AssertionError(f"{name}: the output differs from its plain version on the first {CHECK_LANES} lanes")


def _lanes(ts, m: int = CHECK_LANES):
    return tuple(t[:, :m].contiguous() for t in ts)


def _equal(got, want) -> bool:
    return all(torch.equal(g[:, :CHECK_LANES], w) for g, w in zip(got, want))


def field_benches(batch: int, device) -> None:
    rng = random.Random(1)
    for spec in (FR, FQ):
        p, F = spec.p, mont.field(spec)
        vals = [rng.randrange(p) for _ in range(256)]
        a = mont.to_halves(torch.from_numpy(spec.encode(vals)).to(device).repeat(1, batch // 256))
        b = a.roll(1, dims=1)
        av, bv = vals[:CHECK_LANES], [vals[-1]] + vals[: CHECK_LANES - 1]
        small = a[:, : batch // 16]
        ops = (("add", lambda: F.add(a, b), lambda x, y: (x + y) % p, batch),
               ("sub", lambda: F.sub(a, b), lambda x, y: (x - y) % p, batch),
               ("mul", lambda: F.mul(a, b), lambda x, y: x * y % p, batch),
               ("square", lambda: F.sqr(a), lambda x, _: x * x % p, batch),
               ("invert", lambda: F.inv(small), lambda x, _: pow(x, -1, p), small.shape[1]))
        for op, fn, want, lanes in ops:
            got = spec.decode(mont.to_words(fn()[:, :CHECK_LANES]).cpu().numpy())
            _check(f"{spec.name}/{op}", got == [want(x, y) for x, y in zip(av, bv)])
            emit(f"{spec.name}/{op}", lanes / timeit(fn, device), "elems/s")


def _tile(p, reps: int):
    return tuple(c.repeat(1, reps) for c in p)


def _curve_ops(curve):
    """(add, its plain version, double, its plain version, scalar_mul)."""
    if curve is JUBJUB:
        return (partial(ed.eadd, curve), partial(E.map_add_plain, curve), partial(ed.edouble, curve),
                partial(E.map_double_plain, curve), partial(ed.scalar_mul, curve))
    return (partial(point.padd, curve), partial(ec.map_padd_plain, curve), partial(point.pdouble, curve),
            partial(ec.map_pdouble_plain, curve), partial(point.scalar_mul, curve))


def curve_benches(batch: int, device) -> None:
    rng = random.Random(2)
    for curve, name in ((G1, "g1"), (GRUMPKIN, "grumpkin"), (G2, "g2"), (JUBJUB, "jubjub")):
        n = batch // (4 if name == "g2" else 1)
        g = curve.pyref_spec.generator
        if curve is JUBJUB:
            bases = [(rng.randrange(2, 2**63) * g).to_affine() for _ in range(16)]
            base = JUBJUB.encode_points(bases, device)
        else:
            bases = [rng.randrange(2, 2**63) * g for _ in range(16)]
            base = encode_projective(curve, bases, device)
        add, add_plain, dbl, dbl_plain, smul = _curve_ops(curve)
        pts = _tile(base, n // 16)
        head = _lanes(pts)
        _check(f"{name}/add", _equal(add(pts, pts), add_plain(head, head)))
        emit(f"{name}/add", n / timeit(lambda: add(pts, pts), device), "points/s")
        _check(f"{name}/double", _equal(dbl(pts), dbl_plain(head)))
        emit(f"{name}/double", n / timeit(lambda: dbl(pts), device), "points/s")
        ns = max(n // 256, 16)
        ks = [rng.randrange(2**254) for _ in range(ns)]
        sc = torch.from_numpy(ints_to_limbs16(ks)).to(device)
        small = _tile(base, ns // 16)
        got = _lanes(smul(small, sc))
        if curve is JUBJUB:
            ok = _equal(got, E.scalar_mul_plain(JUBJUB, _lanes(small), sc[:, :CHECK_LANES].contiguous()))
        else:
            ok = decode_points(curve, got) == [k * bases[i % 16] for i, k in enumerate(ks[:CHECK_LANES])]
        _check(f"{name}/scalar_mul", ok)
        emit(f"{name}/scalar_mul", ns / timeit(lambda: smul(small, sc), device), "points/s")


def msm_bench(batch: int, device, dk) -> None:
    n, g = batch, G1.pyref_spec.generator
    x64, y64, inf64 = prepare_points(G1, [k * g for k in dk], device)
    x, y, inf = x64.repeat(1, n // 64), y64.repeat(1, n // 64), inf64.repeat(n // 64)
    sc = np.random.default_rng(4).integers(0, 1 << 16, size=(16, n), dtype=np.uint32)
    sc[15] &= 0x3FFF
    scalars = torch.from_numpy(sc.astype(np.int32)).to(device)
    c = default_window(n)
    if decode_points(G1, msm(G1, x, y, inf, scalars, c=c))[0] != oracle(G1, dk, sc):
        raise AssertionError("msm/g1: the MSM differs from the host oracle")
    emit("msm/g1", n / timeit(lambda: msm(G1, x, y, inf, scalars, c=c), device), "points/s")


def ntt_bench(batch: int, device, rng: random.Random) -> None:
    k = max(10, min(16, batch.bit_length() - 1))
    p = FR.p
    dom = Domain(k, FR, device)
    vals = [rng.randrange(p) for _ in range(1 << k)]
    coeffs = torch.from_numpy(FR.encode(vals)).to(device)
    got = FR.decode(dom.dft(coeffs)[:, :CHECK_LANES].cpu().numpy())
    w = pow(FR.root_of_unity, 1 << (FR.s - k), p)
    want = []
    for i in range(CHECK_LANES):
        x, acc = pow(w, i, p), 0
        for v in reversed(vals):
            acc = (acc * x + v) % p
        want.append(acc)
    _check(f"ntt/fr_2^{k}", got == want)
    emit(f"ntt/fr_2^{k}", (1 << k) / timeit(lambda: dom.dft(coeffs), device), "elems/s")


def native_benches(device) -> None:
    rng = random.Random(5)
    p = FR.p
    state = [Fr(rng.randrange(p)) for _ in range(512)]
    hasher = Mimc(Fr)
    t0 = time.perf_counter()
    acc = Fr(0)
    for s in state:  # `MimcRO.squeeze`'s fold, the native sponge's loop
        acc = acc + s + hasher.hash(s, acc)
    emit("mimc_absorb", len(state) / (time.perf_counter() - t0), "elems/s")

    n = 1 << 14
    indices = [rng.randrange(n) for _ in range(5 * n)]
    data = [rng.randrange(p) for _ in range(5 * n)]
    z = [rng.randrange(p) for _ in range(n)]
    rows = np.repeat(np.arange(n), 5)
    mat = spmv.coo_matrix(rows, indices, data, FR, device)
    zw = torch.from_numpy(FR.encode(z)).to(device)
    got = FR.decode(spmv.matvec(mat, zw, n, FR)[:, :CHECK_LANES].cpu().numpy())
    want = [sum(data[e] * z[indices[e]] for e in range(5 * i, 5 * i + 5)) % p for i in range(CHECK_LANES)]
    _check("spmv", got == want)
    emit("spmv", 5 * n / timeit(lambda: spmv.matvec(mat, zw, n, FR), device), "nnz/s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=1 << 16)
    ap.add_argument("--only", choices=GROUPS, default=None)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)
    if args.batch < 256 or args.batch % 256:
        ap.error("--batch must be a multiple of 256")
    device = resolve(args.device)
    emit("backend", 0, backend_name(device))
    def run(group: str) -> bool:
        return args.only in (None, group)

    if run("field"):
        field_benches(args.batch, device)
    if run("curve"):
        curve_benches(args.batch, device)
    rng = random.Random(3)  # the msm group's bases, then the NTT's coefficients
    dk = [rng.randrange(1, 2**128) for _ in range(64)]
    if run("msm"):
        msm_bench(args.batch, device, dk)
    if run("msm") or run("ntt"):
        ntt_bench(args.batch, device, rng)
    if run("native"):
        native_benches(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
