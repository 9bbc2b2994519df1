#!/usr/bin/env python3
"""Build the port's CUDA kernels and drive the Groth16 and Nova paths on one GPU.

    python3 chip_smoke.py

It takes no options: every phase runs, at full size. Phases, one line each
(a failure raises and the script exits non-zero); every timing is printed
with the card's name and power limit beside it:
  env      torch / CUDA versions and the card (nvidia-smi name, power limit)
  build    nvcc build of kogarashi_tpu_torch/csrc (one process per source),
           ptxas registers/spills, SASS instruction counts (cuobjdump)
  field    csrc/field.cuh against the plain field math on 2^16 Fq and Fr
           elements (mul, sqr, add, sub, neg), exactly, every pair of the
           carry-chain edge values (0, 1, p-1, p-2, R mod p, p's top word)
           among them
  msm      2^20 G1 MSM (bench.py's workload, c = 16) and a 2^16 G2 MSM
           against a host oracle; median of 3 with the host copy inside; the
           scan_proj (K2) launches each MSM made, held against
           ops/msm.py `scan_proj_launches`; the device time of each MSM's
           window combine (15 x map_pdouble t = 16 + map_padd at one lane)
  ec       K1-K4 (scan_mixed, scan_proj, map_padd, map_pdouble) for G1,
           G2 and Grumpkin against their plain versions at the main paths'
           shapes (G1 and G2: K2 at all 13 shapes of the 2^20 MSM and at the
           scan's, K4 at 1, 4 and 2^16 lanes; Grumpkin: K1 and K2 at the
           shapes of one Nova secondary commit's MSM, 78982 points, K3 at
           78982 lanes, K4 at 1 and 4 lanes), exactly, timed on the device
           (ops/ec.py `device_ms`: launches queued behind a spin kernel, so
           the host's launch overhead is not timed) beside their bound
           (ops/ec.py `bound_ms`, at the SM clock nvidia-smi reads under
           load); K2 and K4
           with the lane group g `ops/ec.py::lane_group` picks, K2 with its
           launches per MSM and its time summed over one MSM, K4 at one lane
           with its critical-path floor (levels x t x one dependent multiply's
           cycles, csrc/imad_probe.cu, + an empty launch); then the IMAD and
           IMAD.WIDE issue rates, measured (csrc/imad_probe.cu), beside the
           rate the bound assumes
  groth16  SquareChainCircuit(2^20): setup -> prove -> verify on the card,
           a tampered public input rejected; the kernel launch counters of
           this run must all be > 0 for G1 and G2, and K2's and K4's by lane
           group (`ec.GROUP_LAUNCHES`) for every group of K2 and K4's
           one-lane one
  nova     Nova IVC at the fixture's full size (`phase_nova`): the 3-step
           chain under the reference seed verifies, rejects a tampered z_i,
           and its proof's sha256 is the JAX package's; every Grumpkin and G1
           kernel, and every Grumpkin lane group, launched in it; then a
           timed chain (random.Random(99)): setup, each step, steps/s,
           verify, and a folding step's split into synthesis, cross term,
           G1 and Grumpkin commits, transcripts and folds
The last lines are the kernels' JSON record (name, route, source, replaces,
launches (on the kernel's path: Groth16's for G1 and G2, Nova's for
Grumpkin), path, launches_by_path, max_abs_err, ms, plain_ms, bound_ms,
bound_by, bound_share, library_ms, shape, times, g for K2 and K4, their
other shapes, for K2 and K4 launches_by_g, for K2 msm_sum_ms and
msm_sum_bound_ms, for K4 at one lane floor_ms), the card, and
{"ok": true, "device": {...}}. Without a CUDA device it exits non-zero.
"""

from __future__ import annotations

import json
import logging
import random
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
LOG2_MSM = 20  # the MSM phase's G1 size, and the shapes the ec phase checks
LOG2_CONSTRAINTS = 20  # SquareChainCircuit size of the groth16 phase
# points of one Nova secondary commit: the Grumpkin key's active length,
# max(m, m_l_1) of the augmented secondary circuit (nova/ivc.py)
NOVA_COMMIT = 78982
# sha256 of the JAX package's serialized 3-step RecursiveProof under the
# reference seed. tests/test_fixed_seed_ivc.py:26 pins another value, which
# the JAX package no longer gives: its test fails there, its proof verifies,
# and this is the digest that test reports.
NOVA_PROOF_DIGEST = "488173b8bec07319e19a6949aaf43069f72932c78de84983e2c250d8af183f56"
NOVA_STEPS = 10  # the timed chain's steps (benches/ivc_chain.py's seed, 99)
NOVA_PHASE_S = 90  # ... cut to 5 steps if 10 would take the chain longer
EC_SOURCE = "kogarashi_tpu_torch/csrc/ec.cu"
REPLACES = {
    "scan_mixed": "kogarashi_tpu/ops/ec_pallas.py:336",
    "scan_proj": "kogarashi_tpu/ops/ec_pallas.py:336",
    "map_padd": "kogarashi_tpu/ops/ec_pallas.py:453",
    "map_pdouble": "kogarashi_tpu/ops/ec_pallas.py:453",
}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def smi(query: str, fmt: str = "csv,noheader,nounits") -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean device milliseconds of fn() over `reps` calls in a row, queued
    behind a spin kernel so that the host's launch overhead is not timed
    (ops/ec.py `device_ms`)."""
    import torch

    from kogarashi_tpu_torch.ops.ec import device_ms

    return device_ms(fn, torch.device("cuda", torch.cuda.current_device()), reps)


def sm_clock_under_load(fn, seconds: float = 1.0) -> float:
    """SM clock (Hz) that nvidia-smi reads while a burst of fn() runs."""
    import torch

    t = cuda_ms(fn, reps=1)
    for _ in range(max(1, int(seconds * 1e3 / max(t, 1e-3)))):
        fn()
    time.sleep(0.2)
    mhz = float(smi("clocks.sm"))
    torch.cuda.synchronize()
    return mhz * 1e6


def record_msm(fn):
    """Run fn() (one MSM) and return the shapes of its scan_proj (K2)
    launches, as [(shape, launches)] largest first, and the window sums its
    window combine was given."""
    from kogarashi_tpu_torch.ops import ec
    from kogarashi_tpu_torch.ops import msm as msm_mod

    seen, window_sums = {}, []
    real_scan, real_combine = ec.scan_proj, msm_mod.window_combine

    def scan_spy(curve, *xyz):
        shape = tuple(xyz[0].shape)
        seen[shape] = seen.get(shape, 0) + 1
        return real_scan(curve, *xyz)

    def combine_spy(curve, G, c):
        window_sums.append(G)
        return real_combine(curve, G, c)

    ec.scan_proj, msm_mod.window_combine = scan_spy, combine_spy
    try:
        fn()
    finally:
        ec.scan_proj, msm_mod.window_combine = real_scan, real_combine
    return sorted(seen.items(), key=lambda kv: -kv[0][1] * kv[0][2]), window_sums[0]


def timed(fn):
    """(result, device milliseconds) of one call."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def max_abs_err(a, b) -> int:
    import torch

    return max(int((x.to(torch.int64) - y.to(torch.int64)).abs().max()) if x.numel() else 0
               for x, y in zip(a, b))


def edge_values(p: int) -> list[int]:
    """Carry-chain edge cases: 0, 1, p - 1, p - 2, R mod p, and values below
    p whose top word is p's top word."""
    top, low = p >> 224, p & ((1 << 224) - 1)
    rng = random.Random(p & 0xFFFF)
    return [0, 1, p - 1, p - 2, (1 << 256) % p, top << 224,
            *((top << 224) | rng.randrange(low) for _ in range(8))]


def phase_field(dev, card: str, n: int = 1 << 16) -> None:
    import numpy as np
    import torch

    from kogarashi_tpu_torch.fields import mont
    from kogarashi_tpu_torch.fields.spec import FQ, FR
    from kogarashi_tpu_torch.ops.ec import field_op_cuda

    rng = np.random.default_rng(7)
    for spec, name in ((FQ, "fq"), (FR, "fr")):
        edges = edge_values(spec.p)
        pairs = [(x, y) for x in edges for y in edges]  # every pair, (p-1)(p-1) among them

        def draw(first):
            raw = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
            vals = [int.from_bytes(r.astype("<u4").tobytes(), "little") % spec.p for r in raw]
            vals[: len(first)] = first
            return torch.from_numpy(spec.encode(vals)).to(dev)

        a, b = draw([x for x, _ in pairs]), draw([y for _, y in pairs])
        for op in ("mul", "sqr", "add", "sub", "neg"):
            got = field_op_cuda(name, op, a, b)
            args = {"mul": (a, b), "sqr": (a,), "add": (a, b), "sub": (a, b), "neg": (a,)}[op]
            want = getattr(mont, op)(*args, spec=spec)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"field {name} {op}: CUDA differs from the plain version")
        log("field", f"{spec.name}: mul sqr add sub neg exact on {n} elements, the first "
                     f"{len(pairs)} every pair of the edge values (0, 1, p-1, p-2, R mod p, p's top word)")


def random_points(curve, m: int, seed: int, dev):
    """m random projective points (non-trivial Z) and their affine form."""
    import numpy as np
    import torch

    from kogarashi_tpu_torch.curves import to_affine
    from kogarashi_tpu_torch.ops.fixed_base import fixed_base_mul

    sc = np.random.default_rng(seed).integers(0, 1 << 16, size=(16, m), dtype=np.uint32)
    sc[15] &= 0x3FFF
    sc[0] |= 1  # never the zero scalar
    proj = fixed_base_mul(curve, torch.from_numpy(sc.astype(np.int32)).to(dev))
    return proj, to_affine(curve, proj)


def phase_ec(dev, card: str, log_n: int, windows: int, k2_launches) -> dict:
    """K1-K4 against their plain versions, exactly, and timed, at the shapes
    of the main paths: for G1 and G2 the 2^log_n MSM's, for Grumpkin those
    of one Nova secondary commit (an MSM over NOVA_COMMIT points). The scans
    at the MSM's (all windows side by side: L = scan depth, C = windows * n
    / L over n padded to a multiple of L, each window a permutation of the
    same points); K2 at every shape the MSM gives it (G1 and G2:
    `k2_launches`, [(shape, launches per MSM)], as the 2^log_n G1 MSM gave
    them; Grumpkin: `msm.scan_proj_launches`), and its time and bound summed
    over one MSM's launches; the maps at n lanes (the fixed-base adds of
    Groth16's setup and of Nova's key sampling); map_pdouble with t = 16 at
    the window combine's one lane, at 4 lanes (one the identity) and, for G1
    and G2, at 2^16 lanes, and at one lane its critical-path floor. K2 and K4
    run at the lane group `ec.lane_group` picks (logged as g). Each entry's
    bound is ops.ec.bound_ms at the SM clock nvidia-smi reads under load."""
    import torch

    from kogarashi_tpu_torch.curves import G1, G2, GRUMPKIN
    from kogarashi_tpu_torch.ops import ec
    from kogarashi_tpu_torch.ops.msm import pneg, scan_depth, scan_proj_launches

    gen = torch.Generator(device="cpu").manual_seed(5)
    record, clock = {}, None
    mul_cycles = {"g1": ec.mul_latency_cycles(dev, call=False), "g2": ec.mul_latency_cycles(dev, call=True)}
    mul_cycles["grumpkin"] = mul_cycles["g1"]  # the same inlined 8-word multiply
    launch_ms = ec.empty_launch_ms(dev)
    log("ec", f"one dependent multiply on one thread (csrc/imad_probe.cu): {mul_cycles['g1']:.1f} cycles "
              f"inline (G1), {mul_cycles['g2']:.1f} as G2's call; an empty launch {launch_ms:.5f} ms ({card})")
    nova_k2 = [((GRUMPKIN.rows, *lc), k) for lc, k in scan_proj_launches(NOVA_COMMIT, windows)]
    configs = ((G1, 1, 1 << log_n, k2_launches, (1, 4, 1 << 16)),
               (G2, 2, 1 << log_n, k2_launches, (1, 4, 1 << 16)),
               (GRUMPKIN, 3, NOVA_COMMIT, nova_k2, (1, 4)))
    for curve, seed, n, k2_shapes, k4_lanes in configs:
        rows = curve.rows
        L = scan_depth(windows * n)
        n_pad = n + (-n % L)
        C = windows * n_pad // L
        log("ec", f"{curve.name}: MSM over {n} points, K1 at {(rows, L, C)}, K2 at (L, C) x launches "
                  f"{[(tuple(s[1:]), k) for s, k in k2_shapes]} (msm.scan_proj_launches({n}, {windows}))")
        proj, (ax, ay, _) = random_points(curve, n_pad, seed, dev)
        perms = torch.stack([torch.randperm(n_pad, generator=gen) for _ in range(windows)]).to(dev)

        def scan_layout(t):
            return t[:, perms].reshape(rows, L, C).contiguous()

        def cut(ts, shape):
            return tuple(t.reshape(rows, -1)[:, : shape[1] * shape[2]].reshape(rows, *shape[1:]).contiguous()
                         for t in ts)

        scan_aff = tuple(scan_layout(t) for t in (ax, ay))
        scan_prj = tuple(scan_layout(t) for t in proj)
        p = tuple(t[:, :n].contiguous() for t in proj)
        q = tuple(t[:, :n].roll(1, dims=1).contiguous() for t in proj)
        ident = ec.identity_words(curve, (1,), dev)
        negp = pneg(curve, tuple(t[:, 1:2] for t in p))
        for k in range(3):  # lanes 0-3: P+P, P+(-P), O+Q, P+O
            q[k][:, 0] = p[k][:, 0]
            q[k][:, 1] = negp[k][:, 0]
            p[k][:, 2] = ident[k][:, 0]
            q[k][:, 3] = ident[k][:, 0]
        pd = {m: tuple(t[:, :m].contiguous() for t in p) for m in k4_lanes}
        k2 = [((rows, *s[1:]), k) for s, k in k2_shapes]
        # kernel -> [(shape, times, kernel call, plain call, launches per MSM)]; the first is the entry's
        cases = {
            "scan_mixed": [((rows, L, C), 1, lambda: ec.scan_mixed(curve, *scan_aff),
                            lambda: ec.scan_mixed_plain(curve, *scan_aff), None)],
            "scan_proj": [(s, 1, lambda a=cut(scan_prj, s): ec.scan_proj(curve, *a),
                           lambda a=cut(scan_prj, s): ec.scan_proj_plain(curve, *a), k) for s, k in k2]
                         + [((rows, L, C), 1, lambda: ec.scan_proj(curve, *scan_prj),
                             lambda: ec.scan_proj_plain(curve, *scan_prj), None)],
            "map_padd": [((rows, n), 1, lambda: ec.map_padd(curve, p, q),
                          lambda: ec.map_padd_plain(curve, p, q), None)],
            "map_pdouble": [((rows, m), 16, lambda a=pd[m]: ec.map_pdouble(curve, a, times=16),
                             lambda a=pd[m]: ec.map_pdouble_plain(curve, a, times=16), None)
                            for m in k4_lanes],
        }
        for kname, runs in cases.items():
            measured = []
            for shape, times, kern, plain, per_msm in runs:
                want, plain_ms = timed(plain)
                got, _ = timed(kern)
                err = max_abs_err(got, want)
                if err or not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise AssertionError(f"{kname}_{curve.name} at {shape}: kernel differs from plain version")
                del want, got
                if clock is None:
                    clock = sm_clock_under_load(kern)
                    log("ec", f"SM clock under load {clock / 1e6:.0f} MHz ({card})")
                ms = cuda_ms(kern, reps=10)
                bound, by = ec.bound_ms(kname, curve, shape, clock, times)
                rec = dict(shape=list(shape), times=times, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound, bound_by=by, bound_share=bound / ms)
                extra = ""
                if kname in ("scan_proj", "map_pdouble"):
                    rec["g"] = ec.lane_group(kname, curve, shape[-1])
                    extra = f", g={rec['g']}"
                if per_msm is not None:
                    rec["launches_per_msm"] = per_msm
                    extra += f", {per_msm} per MSM"
                if kname == "map_pdouble" and shape[-1] == 1:
                    levels = ec.PDOUBLE_LEVELS[curve.name]
                    rec["floor_ms"] = levels * times * mul_cycles[curve.name] / clock * 1e3 + launch_ms
                    extra += (f", critical-path floor {rec['floor_ms']:.4f} ms ({levels} levels x t x "
                              f"{mul_cycles[curve.name]:.1f} cycles + a launch)")
                measured.append(rec)
                log("ec", f"{kname}_{curve.name} {tuple(shape)} t={times}: exact; kernel {ms:.4f} ms, "
                          f"bound {bound:.4f} ms ({by}), share {bound / ms:.3f}, plain {plain_ms:.3f} ms"
                          f"{extra} ({card})")
            rec = dict(measured[0], library_ms=None)
            if len(measured) > 1:
                rec["other_shapes"] = measured[1:]
            if kname == "scan_proj":
                per = [m for m in measured if "launches_per_msm" in m]
                rec["msm_sum_ms"] = sum(m["ms"] * m["launches_per_msm"] for m in per)
                rec["msm_sum_bound_ms"] = sum(m["bound_ms"] * m["launches_per_msm"] for m in per)
                log("ec", f"scan_proj_{curve.name} over one {n}-point MSM's {sum(m['launches_per_msm'] for m in per)} "
                          f"launches at {len(per)} shapes: {rec['msm_sum_ms']:.4f} ms, bound "
                          f"{rec['msm_sum_bound_ms']:.4f} ms, share {rec['msm_sum_bound_ms'] / rec['msm_sum_ms']:.3f} ({card})")
            record[f"{kname}_{curve.name}"] = rec
        del scan_aff, scan_prj, p, q, pd, proj, cases
        torch.cuda.empty_cache()
    rates = ec.issue_rates(dev)
    log("ec", f"issue rates per SM per clock (csrc/imad_probe.cu): IMAD {rates['imad']:.2f}, "
              f"IMAD.WIDE in carry chains {rates['imad_wide']:.2f} (= {2 * rates['imad_wide']:.2f} "
              f"multiply-adds); bound_ms assumes {ec.MULADD_PER_SM_CLOCK} multiply-adds ({card})")
    return record


def msm_check(curve, log_n: int, c, seed_pts: int, seed_sc: int, dev, card: str, reps: int = 3):
    """bench.py's workload: 64 distinct bases tiled to 2^log_n, host oracle
    by effective scalar per base. Returns (median s, point-adds/s, the
    scan_proj shapes the MSM launched, largest first)."""
    import numpy as np
    import torch

    from kogarashi_tpu_torch.curves import decode_points, prepare_points
    from kogarashi_tpu_torch.fields.spec import FR
    from kogarashi_tpu_torch.ops.msm import default_window, msm, scan_proj_launches, window_combine

    n, nd = 1 << log_n, 64
    r = FR.p
    g = curve.pyref_spec.generator
    rng = random.Random(seed_pts)
    dk = [rng.randrange(1, r) for _ in range(nd)]
    x64, y64, inf64 = prepare_points(curve, [k * g for k in dk], dev)
    x, y, inf = x64.repeat(1, n // nd), y64.repeat(1, n // nd), inf64.repeat(n // nd)
    sc = np.random.default_rng(seed_sc).integers(0, 1 << 16, size=(16, n), dtype=np.uint32)
    sc[15] &= 0x3FFF  # < 2^254 < r
    scalars = torch.from_numpy(sc.astype(np.int32)).to(dev)

    sums = sc.astype(np.int64).reshape(16, n // nd, nd).sum(axis=1)  # (16, 64)
    eff = [sum(int(sums[l, b]) << (16 * l) for l in range(16)) for b in range(nd)]
    expected = (sum((e % r) * k for e, k in zip(eff, dk)) % r) * g

    c = c or default_window(n)
    # first call: allocator and caches warm, the K2 shapes and the window sums recorded
    k2_shapes, window_sums = record_msm(lambda: msm(curve, x, y, inf, scalars, c=c))
    want_k2 = [((curve.rows, *lc), k) for lc, k in scan_proj_launches(n, c)]
    if dict(k2_shapes) != dict(want_k2):
        raise AssertionError(f"{curve.name} MSM: scan_proj launches {k2_shapes}, worked out {want_k2}")
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = msm(curve, x, y, inf, scalars, c=c)
        host = [o.cpu() for o in out]  # host copy inside the timed window
        times.append(time.perf_counter() - t0)
    if decode_points(curve, host)[0] != expected:
        raise AssertionError(f"{curve.name} MSM 2^{log_n} differs from the host oracle")
    med = statistics.median(times)
    adds = n * -(-256 // c) / med
    log("msm", f"{curve.name} n=2^{log_n} c={c}: oracle PASS; median {med:.4f} s of "
               f"{[round(t, 4) for t in times]}; {adds:.4e} point-adds/s ({card})")
    log("msm", f"{curve.name} n=2^{log_n}: scan_proj (shape, launches) {k2_shapes}, as "
               f"msm.scan_proj_launches works them out")
    combine_ms = cuda_ms(lambda: window_combine(curve, window_sums, c))
    log("msm", f"{curve.name} n=2^{log_n}: window combine ({window_sums[0].shape[1] - 1} x map_pdouble "
               f"t={c} + map_padd at one lane, with the slicing of the window sums) {combine_ms:.4f} ms "
               f"device time ({card})")
    return med, adds, k2_shapes


def phase_groth16(dev, card: str, log2_m: int) -> tuple:
    import torch

    from kogarashi_tpu_torch.curves import G1, G2
    from kogarashi_tpu_torch.groth16 import SquareChainCircuit, setup
    from kogarashi_tpu_torch.ops import ec

    logging.basicConfig(format="[groth16] %(message)s", stream=sys.stdout)
    for name in ("kogarashi_tpu_torch.groth16.setup", "kogarashi_tpu_torch.groth16.prover"):
        logging.getLogger(name).setLevel(logging.INFO)
    circuit = SquareChainCircuit(1 << log2_m)
    cs = circuit.build()
    ec.reset_launches()  # counts from here on are the main path's
    t0 = time.perf_counter()
    prover, verifier = setup(circuit, random.Random(11), device=dev)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    proof = prover.create_proof(circuit, random.Random(12))
    t_prove = time.perf_counter() - t0
    t0 = time.perf_counter()
    ok = verifier.verify(proof, cs.x[1:])
    t_verify = time.perf_counter() - t0
    launches = dict(ec.LAUNCHES)
    by_group = {k: dict(sorted(v.items())) for k, v in ec.GROUP_LAUNCHES.items()}
    bad = verifier.verify(proof, [cs.x[1], cs.x[2] + 1])
    if not ok:
        raise AssertionError("Groth16 proof does not verify")
    if bad:
        raise AssertionError("Groth16 verifier accepted a tampered public input")
    # every kernel, every lane group of K2 (its 13 shapes span them) and K4's
    # one-lane group (the window combine's)
    want = [(f"scan_proj_{c.name}", g) for c in (G1, G2) for g in ec.groups("scan_proj", c)]
    want += [(f"map_pdouble_{c.name}", ec.lane_group("map_pdouble", c, 1)) for c in (G1, G2)]
    missing = [f"{k}_{c.name}" for k in ec.KERNELS for c in (G1, G2) if launches[f"{k}_{c.name}"] <= 0]
    missing += [f"{k} g={g}" for k, g in want if by_group.get(k, {}).get(g, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the Groth16 path: {missing}")
    log("groth16", f"SquareChainCircuit(2^{log2_m}): setup {t_setup:.3f} s, prove {t_prove:.3f} s, "
                   f"verify {t_verify:.3f} s; verify True, tampered input rejected ({card})")
    log("groth16", f"launches: {json.dumps(launches)}")
    log("groth16", f"K2 and K4 launches by lane group g: {json.dumps(by_group)}")
    return launches, by_group


class StepSplit:
    """Wall seconds of the parts of Nova's prove_step, summed while active:
    synthesis (`AugmentedFCircuit.generate`), cross term
    (`R1csShape.cross_term`) and commits by curve
    (`PedersenCommitment.commit`), each ended by a device synchronisation.
    What a step spends elsewhere is transcripts and folds."""

    def __init__(self):
        from kogarashi_tpu_torch.nova.augmented import AugmentedFCircuit
        from kogarashi_tpu_torch.nova.pedersen import PedersenCommitment
        from kogarashi_tpu_torch.nova.relaxed_r1cs import R1csShape

        self.parts = {}
        self.targets = ((AugmentedFCircuit, "generate", lambda self_: "synthesis"),
                        (R1csShape, "cross_term", lambda self_: "cross term"),
                        (PedersenCommitment, "commit", lambda self_: f"commit {self_.curve.name}"))

    def __enter__(self):
        import torch

        self.saved = []
        for owner, name, part in self.targets:
            real = getattr(owner, name)

            def spy(self_, *args, real=real, part=part):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = real(self_, *args)
                torch.cuda.synchronize()
                key = part(self_)
                self.parts[key] = self.parts.get(key, 0.0) + time.perf_counter() - t0
                return out

            self.saved.append((owner, name, real))
            setattr(owner, name, spy)
        return self

    def __exit__(self, *exc):
        for owner, name, real in self.saved:
            setattr(owner, name, real)


def phase_nova(dev, card: str) -> tuple:
    """Nova IVC on the BN254 <-> Grumpkin cycle, at the size of the
    reference's fixture (ExampleFunction; the augmented circuits fix it).
    1. The reference stream: PublicParams.setup from XorShiftRng under the
       reference seed, Ivc, 3 x prove_step; the proof verifies, a tampered
       z_i is rejected, z_i follows z -> z^3 + z + 5 from 0, and the sha256
       of its encoding is the JAX package's (NOVA_PROOF_DIGEST). The kernel
       launch counters are read over this run: every Grumpkin kernel and
       lane group, and every G1 kernel, must have launched.
    2. A timed chain as benches/ivc_chain.py runs it (random.Random(99)):
       setup, NOVA_STEPS steps (5 if 10 would take the chain past
       NOVA_PHASE_S), verify; each step's seconds and the steps' split."""
    import hashlib

    import torch

    from kogarashi_tpu_torch import constants as C
    from kogarashi_tpu_torch.curves import GRUMPKIN
    from kogarashi_tpu_torch.nova import ExampleFunction, Ivc, PublicParams
    from kogarashi_tpu_torch.ops import ec
    from kogarashi_tpu_torch.utils.serde import encode_recursive_proof
    from kogarashi_tpu_torch.utils.xorshift import REFERENCE_TEST_SEED, XorShiftRng

    def chain_state(i):
        z = 0
        for _ in range(i):
            z = (z**3 + z + 5) % C.R
        return [z]

    ec.reset_launches()  # counts from here on are the Nova path's
    t0 = time.perf_counter()
    pp = PublicParams.setup(ExampleFunction, ExampleFunction, XorShiftRng.from_seed(REFERENCE_TEST_SEED),
                            device=dev)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    if pp.ck_secondary.n_active != NOVA_COMMIT:
        raise AssertionError(f"secondary key holds {pp.ck_secondary.n_active} points, not {NOVA_COMMIT}")
    t0 = time.perf_counter()
    ivc = Ivc(pp, z0_primary=[0], z0_secondary=[0])
    for _ in range(3):
        proof = ivc.prove_step()
    t_steps = time.perf_counter() - t0
    t0 = time.perf_counter()
    ok = proof.verify(pp)
    t_verify = time.perf_counter() - t0
    launches = dict(ec.LAUNCHES)
    by_group = {k: dict(sorted(v.items())) for k, v in ec.GROUP_LAUNCHES.items()}
    digest = hashlib.sha256(encode_recursive_proof(proof)).hexdigest()
    if not ok:
        raise AssertionError("Nova: the 3-step reference proof does not verify")
    if proof.zi_primary != chain_state(proof.i):
        raise AssertionError(f"Nova: z_i {proof.zi_primary} after {proof.i} steps")
    if digest != NOVA_PROOF_DIGEST:
        raise AssertionError(f"Nova: proof digest {digest}, the JAX package's is {NOVA_PROOF_DIGEST}")
    proof.zi_primary = [(proof.zi_primary[0] + 1) % C.R]
    if proof.verify(pp):
        raise AssertionError("Nova: a proof with a tampered z_i verified")
    want = [f"{k}_{c}" for k in ec.KERNELS for c in ("g1", "grumpkin")]
    missing = [k for k in want if launches[k] <= 0]
    want_g = [("scan_proj_grumpkin", g) for g in ec.groups("scan_proj", GRUMPKIN)]
    want_g.append(("map_pdouble_grumpkin", ec.lane_group("map_pdouble", GRUMPKIN, 1)))
    missing += [f"{k} g={g}" for k, g in want_g if by_group.get(k, {}).get(g, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the Nova path: {missing}")
    log("nova", f"reference stream: setup {t_setup:.3f} s, Ivc + 3 x prove_step {t_steps:.3f} s, verify "
                f"{t_verify:.3f} s; verify True, z_i = {proof.i}-fold z^3 + z + 5 from 0, tampered z_i "
                f"rejected, proof sha256 {digest} = the JAX package's ({card})")
    log("nova", f"launches: {json.dumps({k: v for k, v in launches.items() if v})}")
    log("nova", f"K2 and K4 launches by lane group g: {json.dumps(by_group)}")

    t0 = time.perf_counter()
    pp = PublicParams.setup(ExampleFunction, ExampleFunction, random.Random(99), device=dev)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    ivc = Ivc(pp, z0_primary=[0], z0_secondary=[0])
    steps, n_steps = [], NOVA_STEPS
    with StepSplit() as split:
        while len(steps) < n_steps:
            t0 = time.perf_counter()
            proof = ivc.prove_step()
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
            if len(steps) == 5 and t_setup + sum(steps) * n_steps / 5 > NOVA_PHASE_S:
                n_steps = 5
    t0 = time.perf_counter()
    ok = proof.verify(pp)
    t_verify = time.perf_counter() - t0
    if not ok or proof.zi_primary != chain_state(proof.i):
        raise AssertionError(f"Nova: the {n_steps}-step chain's proof does not verify")
    folds = len(steps) - 1  # the first step is the base case
    other = sum(steps) - sum(split.parts.values())
    per = {k: v / folds for k, v in sorted(split.parts.items())}
    per["transcripts and folds"] = other / folds
    log("nova", f"timed chain (random.Random(99)): setup {t_setup:.3f} s; steps "
                f"{[round(t, 4) for t in steps]} s; {len(steps) / sum(steps):.4f} steps/s over "
                f"{len(steps)} steps, {folds / sum(steps[1:]):.4f} over the {folds} folding steps; verify "
                f"{t_verify:.3f} s ({card})")
    log("nova", "a folding step's split, s: " + ", ".join(f"{k} {v:.4f}" for k, v in per.items())
        + f" (of {sum(steps[1:]) / folds:.4f}; {card})")
    return launches, by_group


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    if not (ROOT / "kogarashi_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: kogarashi_tpu_torch/ not found beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    dev = torch.device("cuda", 0)
    card = smi("name,power.limit", "csv,noheader")
    log("env", f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
               f"devices {torch.cuda.device_count()}")
    print(card, flush=True)

    from kogarashi_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.lib()
    log("build", f"nvcc sm_90a, one process per source, in {time.perf_counter() - t0:.1f} s -> {path} ({card})")
    for line in _build.ptxas_report():
        log("build", line)
    for line in _build.sass_report():
        log("build", f"sass {line}")

    from kogarashi_tpu_torch.curves import G1, G2

    phase_field(dev, card)
    _, _, k2_launches = msm_check(G1, LOG2_MSM, 16, 0xBE7C4, 1, dev, card)
    msm_check(G2, 16, None, 0xBE7C5, 2, dev, card)
    record = phase_ec(dev, card, LOG2_MSM, windows=16, k2_launches=k2_launches)
    paths = {"groth16": phase_groth16(dev, card, LOG2_CONSTRAINTS), "nova": phase_nova(dev, card)}

    kernels = []
    for key, rec in record.items():
        # G1's and G2's kernels belong to the Groth16 path, Grumpkin's to Nova's
        path = "nova" if key.endswith("_grumpkin") else "groth16"
        launches, by_group = paths[path]
        entry = dict(name=key, route="cuda", source=EC_SOURCE, replaces=REPLACES[key.rsplit("_", 1)[0]],
                     launches=launches[key], path=path,
                     launches_by_path={k: v[0][key] for k, v in paths.items()}, **rec)
        if key in by_group:
            entry["launches_by_g"] = by_group[key]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
