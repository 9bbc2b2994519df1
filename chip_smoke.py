#!/usr/bin/env python3
"""Build the port's CUDA kernels; drive its entry points, Groth16 (prove, verify), its distributed leg, Nova and RedDSA on the GPU.

    python3 chip_smoke.py

It takes no options: every phase runs, at full size. Phases, one line each
(a failure raises and the script exits non-zero); every timing is printed
with the card's name and power limit beside it:
  env      torch / CUDA versions and the card (nvidia-smi name, power limit)
  build    nvcc build of kogarashi_tpu_torch/csrc (one process per source),
           ptxas registers/spills, SASS instruction counts (cuobjdump)
  field    csrc/field.cuh against the plain field math on 2^16 Fq, Fr and
           BLS12-381 Fr elements (mul, sqr, add, sub, neg), exactly, every
           pair of the carry-chain edge values (0, 1, p-1, p-2, R mod p, p's
           top word, values just below p) among them
  msm      2^20 G1 MSM (bench.py's workload, `kogarashi_tpu_torch.bench.
           workload`, c = 16) and a 2^16 G2 MSM against a host oracle; median
           of 3 with the host copy inside; the scan_proj (K2) launches each
           MSM made, held against ops/msm.py `scan_proj_launches`; the device
           time of each MSM's window combine (15 x map_pdouble t = 16 +
           map_padd at one lane)
  entry    `kogarashi_tpu_torch.entry.entry()`'s fn (G1 MSM, c = 8, 128
           points) on the card against `entry.oracle()`
  bench    `python -m kogarashi_tpu_torch.bench` in-process (`bench.run`, 2^20,
           c = 16, 3 reps, every call held to the oracle): its JSON line,
           best and median; entry and bench must each launch K1-K4 (G1)
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
  curves   the generic point ops (`curves.point`): scalar_mul on K3 / K4
           for G1 and Grumpkin at 256 lanes and G2 at 64, edge scalars among
           them, against the host oracle; on_curve and to_affine on the
           results; the K3 / K4 launches these calls made
  micro    `python -m kogarashi_tpu_torch.benches.microbench` in-process at
           its default batch (2^16): every line logged, each op checked on
           its first 16 lanes (plain version or host integers) before it is
           timed; K3 and K4 for G1, G2, Grumpkin, K1 and K2 for G1 and E1-E3
           must each launch
  edwards  E1-E3 (csrc/edwards.cu) exactly against their plain versions:
           E2 and E3 at 2^16 lanes and at the signature path's 1024, E1 at
           2048 lanes and at 16384 (eight tiles of the 2048, each held to the
           plain result; the plain version timed at both), edge scalars
           among them; timed on the device beside `ops/edwards.py::bound_ms`,
           E1-E3 at the path's shapes also beside a critical-path floor;
           E1-E3 with the lane group g `ops/ec.py::lane_group` picks
  signature  RedDSA over Jubjub: 1024 signatures (64 keys, 32-byte messages,
           random.Random(SIG_SEED)), three of them bad (S + 1, a changed
           message, R bytes that do not decompress); `batch_verify` on the
           card equals the host verify on every lane, exactly those three
           rejected; E1-E3 must each have launched in that run, at the
           lane group the rule picks for its shape; then timed at
           1024 and 8192 signatures (the 1024 tiled) with its split (host
           hashing and decompression, encode, E1, the combine, decode), beside
           the host verify's time per signature
  groth16  `python -m kogarashi_tpu_torch.benches.groth16_large` in-process
           (`groth16_large.run`): SquareChainCircuit(2^20), setup
           (random.Random(0x5E7)) -> prove (0xBEEF) -> verify on the card, a
           tampered public input rejected, its JSON line; the proof encoded,
           decoded (G2 subgroup check included) and verified again; the kernel launch
           counters of this run must all be > 0 for G1 and G2, and K2's and
           K4's by lane group (`ec.GROUP_LAUNCHES`) for every group of K2 and
           K4's one-lane one
  distributed  the distributed leg (`kogarashi_tpu_torch.parallel`) under NCCL,
           one rank per visible card (`dryrun_multichip`): the H pipeline at
           2^20 (the groth16 phase's domain) on the 4-step DistributedDomain,
           equal to the single-device Domain pipeline, and the point-sharded
           G1 MSM over 2^20 points (c = 16) on K1-K4 in every rank, equal to
           the host oracle; both timed beside their single-device
           counterparts in the same rank and beside the msm phase's median;
           K1-K4 must each have launched in rank 0's run of the path
  pairing  the groth16 phase's proof's verify equation, e(A, B) e(acc, -gamma)
           e(C, -delta), on the card (csrc/pairing.cu): P1 (Miller loop) and
           P2 (final exponentiation), then P3 (the Fq12 map) compares it with
           alpha_g1_beta_g2 in Gt; P1-P3 must each have launched in that run;
           the result equals the host's, bit for bit, and a changed public
           input is rejected; pairing_device = pairing_fast on (a G1, G2) for
           a = 1, 2, r - 1 and two seeded values; P1 and P2 held to their
           plain versions on the card and timed beside their depth floor (the
           schedule's levels at one dependent inline multiply, the Fermat
           inverse's chain, a launch), their one-thread floor and the host
           pairing's seconds, with the build's registers, stack and spills;
           P3's verify-equation launches (conj, mul at one lane) on the
           routes `ops/pairing.py::p3_route` picks; P3 at one lane and at
           2^16 lanes, every op (mul, sq, inv, frobenius, conj, mul_by_034)
           on the route the rule picks, held to its plain version and timed
           beside its bound and its schedule route's depth floor
  nova     Nova IVC at the fixture's full size (`phase_nova`): the 3-step
           chain under the reference seed verifies, rejects a tampered z_i,
           and its proof's sha256 is the JAX package's; every Grumpkin and G1
           kernel, and every Grumpkin lane group, launched in it; its bytes
           decode, and `pallet.NovaPallet.verify` accepts them (event
           ProofVerified), `SamplePallet.set_thing_1` sets its value, and the
           bytes with one commitment byte flipped raise MalformedProof, and
           the proof re-encoded with w_range_primary.e = [] is rejected;
           `Ivc.resume` from the decoded bytes takes one step, whose sha256
           equals the uninterrupted chain's step 4; then
           `python -m kogarashi_tpu_torch.benches.ivc_chain` in-process
           (`ivc_chain.run`, random.Random(99), 10 steps or 5 if 10 would pass
           NOVA_PHASE_S): its checks and JSON line, each step, steps/s,
           verify, and a folding step's split into synthesis, cross term,
           G1 and Grumpkin commits, transcripts and folds
The last lines are the kernels' JSON record (name, route, source, replaces,
launches (on the kernel's path: Groth16's for G1 and G2, Nova's for
Grumpkin, the 1024-signature batch_verify's for E1-E3, the verify
equation's for P1-P3), path, launches_by_path (for G1's also the
distributed path's, counted inside rank 0, and the entry and bench steps';
every kernel's also the micro phase's), max_abs_err, ms, plain_ms,
bound_ms, bound_by, bound_share, library_ms, shape, times, g for K2 and K4,
their other shapes, for K2, K4, E1-E3 launches_by_g (E1-E3 also g), for
K2 msm_sum_ms and msm_sum_bound_ms, for K4 at one lane, E1 at 2048 lanes,
E2 and E3 at 1024 floor_ms, for P1 and P2 threads, one_thread_floor_ms,
depth_floor_ms and its share, levels, the build's registers and the host's
seconds, for P3 (at one lane) p3_route, depth_floor_ms, other_ops, wide (2^16
lanes) and launches_by_route), the card, and {"ok": true, "device": {...}}. Without a
CUDA device it exits non-zero.
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
SIG_SEED = 0x5EED  # random.Random seed of the signature phase's keys, messages and signatures
SIG_N, SIG_KEYS, SIG_TILES = 1024, 64, 8  # signatures, keys; the timed 8192 tiles the 1024
SIG_BAD = {100: "S + 1", 517: "a changed message", 903: "R bytes that do not decompress"}
E1_LANES = 2 * SIG_N  # E1's lanes on the 1024-signature path; timed also at SIG_TILES times that
ED_MAP_LANES = 1 << 16  # E2 and E3 are timed here and at the path's SIG_N
EC_SOURCE = "kogarashi_tpu_torch/csrc/ec.cu"
ED_SOURCE = "kogarashi_tpu_torch/csrc/edwards.cu"
ED_REPLACES = {
    "ed_scalar_mul": "kogarashi_tpu/curves/edwards.py:110 (scalar_mul, a lax.scan under jax.jit; XLA, no Pallas kernel)",
    "ed_map_add": "kogarashi_tpu/curves/edwards.py:77 (eadd, with eneg :67; XLA, no Pallas kernel)",
    "ed_map_double": "kogarashi_tpu/curves/edwards.py:96 (edouble; XLA, no Pallas kernel)",
}
PAIR_SOURCE = "kogarashi_tpu_torch/csrc/pairing.cu"
PAIR_REPLACES = {
    "pair_miller_loop": "kogarashi_tpu/ops/pairing.py:331 (_miller_scan, a lax.scan under jax.jit; XLA, no Pallas kernel)",
    "pair_final_exp": "kogarashi_tpu/ops/pairing.py:360 (final_exp_device, a lax.scan under jax.jit; XLA, no Pallas kernel)",
    "f12_map": "kogarashi_tpu/ops/pairing.py:383-385 (f12_mul_jit, f12_sq_jit, f12_inv_jit; with f12_frobenius :233, "
               "f12_conj :204, f12_mul_by_034 :213; XLA, no Pallas kernel)",
}
P3_LANES = 1 << 16  # P3 is held to its plain version and timed at this many lanes and at one, every op
PAIRING_SEED = 0x9A1
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
    """Carry-chain edge cases: 0, 1, p - 1, p - 2, R mod p, values below p
    whose top word is p's top word, and values just below p."""
    top, low = p >> 224, p & ((1 << 224) - 1)
    rng = random.Random(p & 0xFFFF)
    return [0, 1, p - 1, p - 2, (1 << 256) % p, top << 224,
            *((top << 224) | rng.randrange(low) for _ in range(8)), p - 3, p - (1 << 32), p - (1 << 128)]


def phase_field(dev, card: str, n: int = 1 << 16) -> None:
    import numpy as np
    import torch

    from kogarashi_tpu_torch.fields import mont
    from kogarashi_tpu_torch.fields.spec import BLS_FR, FQ, FR
    from kogarashi_tpu_torch.ops.ec import field_op_cuda

    rng = np.random.default_rng(7)
    for spec, name in ((FQ, "fq"), (FR, "fr"), (BLS_FR, "blsfr")):
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
                     f"{len(pairs)} every pair of the edge values (0, 1, p-1, p-2, R mod p, p's top word, "
                     f"just below p)")


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
    """bench.py's workload (`kogarashi_tpu_torch.bench.workload`: 64 distinct
    bases tiled to 2^log_n, host oracle by effective scalar per base).
    Returns (median s, point-adds/s, the scan_proj shapes the MSM launched,
    largest first)."""
    import torch

    from kogarashi_tpu_torch.bench import workload
    from kogarashi_tpu_torch.curves import decode_points
    from kogarashi_tpu_torch.ops.msm import default_window, msm, scan_proj_launches, window_combine

    n = 1 << log_n
    x, y, inf, scalars, expected = workload(log_n, dev, curve, seed_pts, seed_sc)
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


def phase_bench(dev, card: str) -> dict:
    """The port's entry points on the msm phase's workload: `entry.entry()`'s
    fn (the G1 MSM at c = 8 over `__graft_entry__.py`'s 128 points) on the
    card against `entry.oracle()`, then `python -m kogarashi_tpu_torch.bench`
    run in-process (`bench.run` at 2^LOG2_MSM, c = 16, 3 reps: the first call
    and every rep held to the oracle) with its JSON logged. Each must launch
    every G1 kernel. Returns their K1-K4 launches by path."""
    from kogarashi_tpu_torch import bench, entry
    from kogarashi_tpu_torch.curves import G1, decode_points
    from kogarashi_tpu_torch.ops import ec

    paths = {}
    ec.reset_launches()
    t0 = time.perf_counter()
    fn, args = entry.entry(dev)
    got = decode_points(G1, fn(*args))[0]
    t_entry = time.perf_counter() - t0
    paths["entry"] = dict(ec.LAUNCHES)
    if got != entry.oracle():
        raise AssertionError("entry: fn(*example_args) differs from the oracle")
    log("entry", f"entry(): msm on G1, c = {fn.keywords['c']}, over {args[0].shape[1]} points "
                 f"(__graft_entry__.py's): oracle PASS; {t_entry:.3f} s with the inputs' encoding ({card})")
    ec.reset_launches()
    result, info = bench.run(LOG2_MSM, 16, 3, dev)
    paths["bench"] = dict(ec.LAUNCHES)
    log("bench", json.dumps(result))
    log("bench", f"n=2^{LOG2_MSM} c={info['c']} windows={info['windows']}: best {info['best']:.6f} s, median "
                 f"{info['median']:.6f} s of {[round(t, 6) for t in info['times']]}; first call "
                 f"{info['first_s']:.4f} s; oracle PASS on every call ({card})")
    for path, launches in paths.items():
        missing = [f"{k}_g1" for k in ec.KERNELS if launches[f"{k}_g1"] <= 0]
        if missing:
            raise AssertionError(f"kernels not launched on the {path} path: {missing}")
        log(path, f"launches: {json.dumps({k: v for k, v in launches.items() if v})}")
    return paths


def phase_micro(card: str) -> dict:
    """`python -m kogarashi_tpu_torch.benches.microbench` at its default
    batch, run in-process, every line logged: each op is checked on its
    first lanes before it is timed (a failed check raises). Every K1-K4
    (G1, G2, Grumpkin) point map and E1-E3 must launch. Returns the run's
    K1-K4 and E1-E3 launches."""
    import contextlib
    import io

    from kogarashi_tpu_torch.benches import microbench
    from kogarashi_tpu_torch.ops import ec
    from kogarashi_tpu_torch.ops import edwards as E

    ec.reset_launches()
    E.reset_launches()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        microbench.main([])
    seconds = time.perf_counter() - t0
    for line in out.getvalue().splitlines():
        log("micro", line)
    launches = {**ec.LAUNCHES, **E.LAUNCHES}
    want = [f"{k}_{c}" for k in ("map_padd", "map_pdouble") for c in ("g1", "g2", "grumpkin")]
    want += [f"{k}_g1" for k in ("scan_mixed", "scan_proj")] + list(E.LAUNCHES)
    missing = [k for k in want if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the microbench: {missing}")
    log("micro", f"the matrix in {seconds:.1f} s; launches: {json.dumps({k: v for k, v in launches.items() if v})} "
                 f"({card})")
    return launches


def phase_curves(dev, card) -> dict:
    """The generic point ops on K3 / K4 (`curves.point`): scalar_mul for G1
    and Grumpkin at 256 lanes and G2 at 64, edge scalars (0, 1, order - 1,
    order, 2^256 - 1) and an identity lane among them, against the host
    oracle; on_curve and to_affine on the results. Returns the K3 / K4
    launches these calls made (each scalar_mul: 256 of each)."""
    import torch

    from kogarashi_tpu_torch.curves import G1, G2, GRUMPKIN, decode_affine, decode_points, encode_projective, point
    from kogarashi_tpu_torch.fields.spec import FQ, FR, ints_to_limbs16
    from kogarashi_tpu_torch.ops import ec

    ec.reset_launches()
    for curve, lanes, order in ((G1, 256, FR.p), (GRUMPKIN, 256, FQ.p), (G2, 64, FR.p)):
        rng = random.Random(lanes + curve.rows)
        g = curve.pyref_spec.generator
        bases = [rng.randrange(1, order) * g for _ in range(15)] + [curve.pyref_spec.identity_affine()]
        pts = [bases[i % 16] for i in range(lanes)]
        ks = [0, 1, order - 1, order, (1 << 256) - 1] + [rng.randrange(1 << 256) for _ in range(lanes - 5)]
        p = encode_projective(curve, pts, dev)
        k = torch.from_numpy(ints_to_limbs16(ks)).to(dev)
        before = (ec.LAUNCHES[f"map_padd_{curve.name}"], ec.LAUNCHES[f"map_pdouble_{curve.name}"])
        out, ms = timed(lambda: point.scalar_mul(curve, p, k))
        launched = (ec.LAUNCHES[f"map_padd_{curve.name}"] - before[0],
                    ec.LAUNCHES[f"map_pdouble_{curve.name}"] - before[1])
        want = [kk * q for kk, q in zip(ks, pts)]
        if decode_points(curve, out) != want:
            raise AssertionError(f"curves: {curve.name} scalar_mul differs from the host oracle")
        if not bool(point.on_curve(curve, out).all()):
            raise AssertionError(f"curves: {curve.name} scalar_mul result off the curve")
        ax, ay, inf = point.to_affine(curve, out)
        if decode_affine(curve, ax, ay, inf) != want:
            raise AssertionError(f"curves: {curve.name} to_affine differs from the host oracle")
        if launched != (256, 256):
            raise AssertionError(f"curves: {curve.name} scalar_mul made {launched} K3 / K4 launches, not 256 each")
        log("curves", f"{curve.name} scalar_mul at {lanes} lanes (edge scalars, an identity lane): oracle PASS, "
                      f"on_curve and to_affine PASS; {ms:.3f} ms, K3 {launched[0]} + K4 {launched[1]} launches "
                      f"({card})")
    launches = {k: v for k, v in ec.LAUNCHES.items() if v}
    log("curves", f"launches: {json.dumps(launches)}")
    return launches


def phase_edwards(dev, card) -> dict:
    """E1-E3 exactly against their plain versions and timed on the device
    beside `ops/edwards.py::bound_ms` (at the SM clock under load). E1 at
    2048 lanes (the 1024-signature path's) and at 16384 (the 8192-signature
    path's: eight tiles of the 2048 inputs, each held to the plain result),
    the plain version timed at both, with its critical-path floor
    (LADDER_LEVELS x 256 x one dependent multiply's cycles, csrc/
    imad_probe.cu, + an empty launch); E2 (p - q, the path's form) and E3
    (t = 3) at the paths' 1024 (the shape the kernels line records) and 8192
    and at 2^16 lanes, E2 and E3 at 1024 beside their floors (ADD_LEVELS, or DOUBLE_LEVELS x t, x one dependent
    multiply + an empty launch). E1-E3 run at the lane group `ec.lane_group`
    picks (logged as g)."""
    import torch

    from kogarashi_tpu_torch.curves.edwards import JUBJUB
    from kogarashi_tpu_torch.ops import ec
    from kogarashi_tpu_torch.ops import edwards as E
    from kogarashi_tpu_torch.profile_edwards import jubjub_lanes

    mul_cycles = ec.mul_latency_cycles(dev, call=False)
    launch_ms = ec.empty_launch_ms(dev)
    p, k = jubjub_lanes(E1_LANES, 11, dev)
    p16, k16 = tuple(c.repeat(1, SIG_TILES) for c in p), k.repeat(1, SIG_TILES)
    want, plain_ms = timed(lambda: E.scalar_mul_plain(JUBJUB, p, k))
    plain_ms = {E1_LANES: plain_ms, E1_LANES * SIG_TILES: timed(lambda: E.scalar_mul_plain(JUBJUB, p16, k16))[1]}
    clock = sm_clock_under_load(lambda: E.scalar_mul(JUBJUB, p16, k16))
    log("edwards", f"SM clock under load {clock / 1e6:.0f} MHz; one dependent multiply {mul_cycles:.1f} cycles, "
                   f"an empty launch {launch_ms:.5f} ms ({card})")
    record = {}
    runs = {"ed_scalar_mul": [], "ed_map_add": [], "ed_map_double": []}
    for lanes, pp, kk in ((E1_LANES, p, k), (E1_LANES * SIG_TILES, p16, k16)):
        got = E.scalar_mul(JUBJUB, pp, kk)
        torch.cuda.synchronize()
        err = max(max_abs_err(tuple(c[:, t * E1_LANES:(t + 1) * E1_LANES] for c in got), want)
                  for t in range(lanes // E1_LANES))
        if err:
            raise AssertionError(f"ed_scalar_mul at {lanes} lanes: kernel differs from the plain version")
        ms = cuda_ms(lambda: E.scalar_mul(JUBJUB, pp, kk), reps=5)
        bound, by = E.bound_ms("ed_scalar_mul", lanes, clock, base_lanes=lanes)
        floor = E.floor_ms("ed_scalar_mul", mul_cycles, clock, launch_ms)
        g = ec.lane_group("ed_scalar_mul", JUBJUB, lanes)
        runs["ed_scalar_mul"].append(dict(shape=[8, lanes], times=1, g=g, max_abs_err=err, ms=ms,
                                          plain_ms=plain_ms[lanes], bound_ms=bound, bound_by=by,
                                          bound_share=bound / ms, floor_ms=floor))
        log("edwards", f"ed_scalar_mul (8, {lanes}) g={g}: exact (edge scalars among them); kernel {ms:.4f} ms, "
                       f"bound {bound:.4f} ms ({by}), share {bound / ms:.3f}, critical-path floor {floor:.4f} ms "
                       f"({E.LADDER_LEVELS} levels x 256 bits x {mul_cycles:.1f} cycles + a launch)"
                       f", plain {plain_ms[lanes]:.1f} ms ({card})")
    del p16, k16, want
    for lanes in (SIG_N, SIG_N * SIG_TILES, ED_MAP_LANES):  # first the shape the kernels line records
        a, _ = jubjub_lanes(lanes, 12, dev)
        b = tuple(c.roll(1, dims=1).contiguous() for c in a)
        cases = (("ed_map_add", 1, lambda: E.map_add(JUBJUB, a, b, neg=True),
                  lambda: E.map_add_plain(JUBJUB, a, b, neg=True)),
                 ("ed_map_double", 3, lambda: E.map_double(JUBJUB, a, 3),
                  lambda: E.map_double_plain(JUBJUB, a, 3)))
        for kname, times, kern, plain in cases:
            want, plain_ms = timed(plain)
            got, _ = timed(kern)
            err = max_abs_err(got, want)
            if err:
                raise AssertionError(f"{kname} at {lanes} lanes: kernel differs from the plain version")
            ms = cuda_ms(kern, reps=20)
            bound, by = E.bound_ms(kname, lanes, clock, times=times)
            rec = dict(shape=[8, lanes], times=times, g=ec.lane_group(kname, JUBJUB, lanes), max_abs_err=err,
                       ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by, bound_share=bound / ms)
            extra = f" g={rec['g']}"
            if lanes == SIG_N:
                rec["floor_ms"] = E.floor_ms(kname, mul_cycles, clock, launch_ms, times)
                levels = E.ADD_LEVELS if kname == "ed_map_add" else E.DOUBLE_LEVELS * times
                extra += (f", critical-path floor {rec['floor_ms']:.5f} ms ({levels} levels x "
                          f"{mul_cycles:.1f} cycles + a launch)")
            runs[kname].append(rec)
            log("edwards", f"{kname} (8, {lanes}) t={times}: exact; kernel {ms:.4f} ms, bound {bound:.5f} ms "
                           f"({by}), share {bound / ms:.3f}, plain {plain_ms:.3f} ms;{extra} ({card})")
    for kname, measured in runs.items():
        record[f"{kname}_jubjub"] = dict(measured[0], library_ms=None, other_shapes=measured[1:])
    return record


class StageLog(logging.Handler):
    """Collects `stages.Stages` records of one logger: [(stage, seconds)]."""

    def __init__(self, name: str):
        super().__init__(logging.INFO)
        self.logger = logging.getLogger(name)
        self.stages = []

    def __enter__(self):
        self.saved = (self.logger.level, self.logger.propagate)
        self.logger.setLevel(logging.INFO)
        self.logger.propagate = False
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)
        self.logger.setLevel(self.saved[0])
        self.logger.propagate = self.saved[1]

    def emit(self, record):
        _, stage, seconds = record.args
        self.stages.append((stage, seconds))


def ed_groups() -> dict:
    """E1-E3's launches by lane group since the last reset."""
    from kogarashi_tpu_torch.ops import ec

    return {k: dict(v) for k, v in ec.GROUP_LAUNCHES.items() if k.startswith("ed_")}


def missing_groups(n: int, by_group: dict) -> list:
    """E1-E3 of a batch_verify over n signatures (E1 on 2n lanes, E2 and E3
    on n) that did not launch at the lane group the rule picks."""
    from kogarashi_tpu_torch.curves.edwards import JUBJUB
    from kogarashi_tpu_torch.ops import ec

    path_g = {k: ec.lane_group(k, JUBJUB, lanes)
              for k, lanes in (("ed_scalar_mul", 2 * n), ("ed_map_add", n), ("ed_map_double", n))}
    return [f"{k} g={g}" for k, g in path_g.items() if by_group.get(f"{k}_jubjub", {}).get(g, 0) <= 0]


def phase_signature(dev, card) -> dict:
    """RedDSA batch verification over Jubjub on the card. 1024 signatures
    from random.Random(SIG_SEED): 64 keys, 32-byte messages; the lanes of
    SIG_BAD made bad. The host verify runs on every lane (its time per
    signature logged); `batch_verify` on the card must equal it on every
    lane and reject exactly SIG_BAD. The launch counters are read over that
    first call: E1-E3 must each have launched, at the lane groups the rule
    picks. Then 1024 and 8192 signatures (the 1024 tiled) are timed
    with their split (`stages.Stages` in `signature/reddsa.py`, each stage
    ended by a device synchronisation), each run held to the host verify and
    to having launched E1-E3 at its own lane groups."""
    from kogarashi_tpu_torch.ops import edwards as E
    from kogarashi_tpu_torch.pyref import JUBJUB_SPEC
    from kogarashi_tpu_torch.signature import RedDSA, Signature, batch_verify

    rng = random.Random(SIG_SEED)
    t0 = time.perf_counter()
    keys = [RedDSA().keygen(rng) for _ in range(SIG_KEYS)]
    vks, msgs, sigs = [], [], []
    for i in range(SIG_N):
        sk, vk = keys[i % SIG_KEYS]
        msgs.append(bytes(rng.randrange(256) for _ in range(32)))
        sigs.append(sk.sign(msgs[-1], rng))
        vks.append(vk)
    t_sign = time.perf_counter() - t0
    bad = sorted(SIG_BAD)
    sigs[bad[0]] = Signature(sigs[bad[0]].r_bytes, (sigs[bad[0]].s + 1) % JUBJUB_SPEC.order)
    msgs[bad[1]] = bytes([msgs[bad[1]][0] ^ 1]) + msgs[bad[1]][1:]
    sigs[bad[2]] = Signature(b"\xff" * 32, sigs[bad[2]].s)
    t0 = time.perf_counter()
    host = [vk.verify(m, sg) for vk, m, sg in zip(vks, msgs, sigs)]
    t_host = (time.perf_counter() - t0) / SIG_N
    if [i for i, ok in enumerate(host) if not ok] != bad:
        raise AssertionError(f"signature: the host verify rejects {[i for i, ok in enumerate(host) if not ok]}")

    E.reset_launches()  # counts from here on are the signature path's
    t0 = time.perf_counter()
    got = batch_verify(vks, msgs, sigs, device=dev)
    t_first = time.perf_counter() - t0
    launches = dict(E.LAUNCHES)
    by_group = ed_groups()
    if got != host:
        raise AssertionError(f"signature: batch_verify differs from the host verify at "
                             f"{[i for i, (a, b) in enumerate(zip(got, host)) if a != b]}")
    missing = [k for k, v in launches.items() if v <= 0] + missing_groups(SIG_N, by_group)
    if missing:
        raise AssertionError(f"kernels not launched on the signature path: {missing}")
    log("signature", f"{SIG_N} signatures over {SIG_KEYS} keys (signed on the host in {t_sign:.3f} s): "
                     f"batch_verify on the card equals the host verify on every lane, rejecting exactly "
                     f"{bad} ({', '.join(SIG_BAD[i] for i in bad)}); first call {t_first:.3f} s; host verify "
                     f"{t_host * 1e3:.3f} ms per signature ({card})")
    log("signature", f"launches: {json.dumps(launches)}; E1-E3 by lane group g: {json.dumps(by_group)}")
    for tiles in (1, SIG_TILES):
        n = SIG_N * tiles
        E.reset_launches()
        with StageLog("kogarashi_tpu_torch.signature.reddsa") as st:
            t0 = time.perf_counter()
            got = batch_verify(vks * tiles, msgs * tiles, sigs * tiles, device=dev)
            total = time.perf_counter() - t0
        if got != host * tiles:
            raise AssertionError(f"signature: batch_verify at {n} signatures differs from the host verify")
        missing = missing_groups(n, ed_groups())
        if missing:
            raise AssertionError(f"signature: at {n} signatures, not launched: {missing}")
        split = ", ".join(f"{k} {v:.4f}" for k, v in st.stages)
        log("signature", f"batch_verify at {n} signatures: {total:.4f} s, {n / total:.1f} signatures/s "
                         f"({total / n * 1e3:.4f} ms each; host verify {t_host * 1e3:.3f} ms each); split, s: "
                         f"{split}; E1-E3 by lane group g: {json.dumps(ed_groups())} ({card})")
    return launches, by_group


def random_fq12_words(n: int, seed: int, dev, rows: int = 96):
    """(rows, n) canonical Fq words: each component's top word below q's, so
    every value is below q."""
    import torch

    from kogarashi_tpu_torch.fields.spec import FQ

    gen = torch.Generator(device="cpu").manual_seed(seed)
    w = torch.randint(-(1 << 31), 1 << 31, (rows // 8, 8, n), dtype=torch.int64, generator=gen)
    w[:, 7] = torch.randint(0, FQ.p >> 224, (rows // 8, n), generator=gen)
    return w.to(torch.int32).reshape(rows, n).to(dev)


def phase_pairing(dev, card: str, proof, inputs, pvk) -> tuple:
    """The Groth16 verify equation of phase_groth16's 2^20 proof on the card:
    e(A, B) e(acc, -gamma) e(C, -delta) through P1 (`multi_miller_loop_device`)
    and P2 (`final_exp_device`), held to `pvk.alpha_g1_beta_g2` by P3 (Gt's
    f - target, `ops/pairing.py::gt_eq_device`). The launch counters are read
    over that run: P1-P3 must each have launched, P3's conj and mul on the
    routes `p3_route` picks at one lane. The result must equal the
    host's `final_exp_fast(multi_miller_loop(...))` bit for bit, the Miller
    loop's too, and a changed public input must be rejected; `pairing_device`
    must equal `pairing_fast` on (a G1, G2) for a = 1, 2, r - 1 and two seeded
    values. P1 and P2 are held to their plain versions on the card and timed
    (`ec.device_ms`) beside their depth and one-thread floors, the build's
    registers and the host pairing's time for the same equation; P3 at one
    lane and at P3_LANES lanes, every op, on the route the rule picks (each
    call required to launch there), against its plain version, timed beside
    its bound and its schedule route's depth floor."""
    import torch

    from kogarashi_tpu_torch import constants as C
    from kogarashi_tpu_torch.ops import _build, ec
    from kogarashi_tpu_torch.ops import pairing as P
    from kogarashi_tpu_torch.pyref import G1_SPEC, G2_SPEC
    from kogarashi_tpu_torch.pyref.pairing_fast import final_exp_fast, multi_miller_loop, pairing_fast

    pairs = proof.pairs(pvk, inputs)
    t0 = time.perf_counter()
    host_ml = multi_miller_loop(pairs)
    t_host_ml = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_fe = final_exp_fast(host_ml)
    t_host_fe = time.perf_counter() - t0
    host_ok = host_fe == pvk.alpha_g1_beta_g2

    P.reset_launches()  # counts from here on are the verify equation's
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ml = P.multi_miller_loop_device(pairs, dev)
    fe = P.final_exp_device(ml)
    ok = P.gt_eq_device(fe, pvk.alpha_g1_beta_g2)
    t_dev = time.perf_counter() - t0
    launches, routes = dict(P.LAUNCHES), dict(P.ROUTE_LAUNCHES)
    if not (ok and host_ok):
        raise AssertionError(f"pairing: the verify equation does not hold (card {ok}, host {host_ok})")
    missing = [k for k, v in launches.items() if v <= 0]
    missing += [f"f12_map {op} on the {P.p3_route(op, 1)} route" for op in ("conj", "mul")
                if routes[P.p3_route(op, 1)] <= 0]
    if missing or sum(routes.values()) != launches["f12_map"]:
        raise AssertionError(f"kernels not launched on the Groth16 verify equation: {missing} ({routes})")
    if not torch.equal(ml, P.encode_fq12(host_ml, dev)) or not torch.equal(fe, P.encode_fq12(host_fe, dev)):
        raise AssertionError("pairing: the card's Miller loop or final exponentiation differs from the host's")
    bad = proof.pairs(pvk, [inputs[0], (inputs[1] + 1) % C.R] + list(inputs[2:]))
    if P.gt_eq_device(P.final_exp_device(P.multi_miller_loop_device(bad, dev)), pvk.alpha_g1_beta_g2):
        raise AssertionError("pairing: the card accepted a changed public input")
    rng = random.Random(PAIRING_SEED)
    g1, g2 = G1_SPEC.generator, G2_SPEC.generator
    for a in (1, 2, C.R - 1, rng.randrange(1, C.R), rng.randrange(1, C.R)):
        if P.decode_fq12(P.pairing_device(a * g1, g2, dev)) != pairing_fast(a * g1, g2):
            raise AssertionError(f"pairing: pairing_device(a G1, G2) differs from pairing_fast at a = {a}")
    log("pairing", f"2^{LOG2_CONSTRAINTS} Groth16 proof's verify equation on P1 + P2 (+ P3's Gt check): holds "
                   f"({t_dev * 1e3:.2f} ms wall with the host's line encoding), equal to the host's Miller loop and "
                   f"final exponentiation bit for bit; a changed public input rejected; pairing_device = "
                   f"pairing_fast at a = 1, 2, r - 1 and two seeded values; host pairing of the same equation: "
                   f"Miller loop {t_host_ml:.4f} s + final exponentiation {t_host_fe:.4f} s ({card})")
    log("pairing", f"launches: {json.dumps(launches)}; f12_map by route: {json.dumps(routes)}")

    mul_cycles = ec.mul_latency_cycles(dev, call=True)
    inline_cycles = ec.mul_latency_cycles(dev, call=False)
    launch_ms = ec.empty_launch_ms(dev)
    a = random_fq12_words(P3_LANES, 1, dev)
    b = random_fq12_words(P3_LANES, 2, dev)
    c = random_fq12_words(P3_LANES, 3, dev, rows=48)
    clock = sm_clock_under_load(lambda: P.f12_mul(a, b))
    log("pairing", f"SM clock under load {clock / 1e6:.0f} MHz; one dependent multiply {inline_cycles:.1f} cycles "
                   f"inline, {mul_cycles:.1f} through fp_mul_call; an empty launch {launch_ms:.5f} ms ({card})")
    builds = {line.split(":")[0]: line.split(": ", 1)[1] for line in _build.ptxas_report()}
    record = {}
    coeffs = P._encode_prepared(pairs, dev)
    n_pairs = len(pairs)
    threads = P.pair_threads()
    for kname, kern, plain, want_out in (
            ("pair_miller_loop", lambda: P.miller_loop_coeffs(coeffs), lambda: P.miller_loop_plain(coeffs), ml),
            ("pair_final_exp", lambda: P.final_exp_device(ml), lambda: P.final_exp_plain(ml), fe)):
        want, plain_ms = timed(plain)
        err = max_abs_err((want_out,), (want,))
        if err or not torch.equal(kern(), want):
            raise AssertionError(f"{kname}: kernel differs from the plain version")
        ms = cuda_ms(kern, reps=10)
        bound, by = P.bound_ms(kname, clock, n_pairs=n_pairs)
        one = P.one_thread_floor_ms(kname, mul_cycles, clock, launch_ms, n_pairs=n_pairs)
        depth = P.depth_floor_ms(kname, inline_cycles, mul_cycles, clock, launch_ms, n_pairs=n_pairs)
        levels, inverses = P.depth_levels(kname, n_pairs)
        build = builds.get(f"{kname}_kernel", "not in the ptxas log")
        shape = list(coeffs.shape) if kname == "pair_miller_loop" else [96]
        record[kname] = dict(shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                             bound_share=bound / ms, threads=threads, one_thread_floor_ms=one,
                             depth_floor_ms=depth, depth_floor_share=depth / ms, levels=levels,
                             fermat_inverses=inverses, fq_muls=P.schedule_muls(kname, n_pairs), build=build,
                             host_s=t_host_ml if kname == "pair_miller_loop" else t_host_fe)
        log("pairing", f"{kname} {tuple(shape)}: exact; kernel {ms:.4f} ms on a block of {threads} threads; depth "
                       f"floor {depth:.4f} ms ({levels} levels x {inline_cycles:.1f} cycles + {inverses} Fermat "
                       f"inverse of {P._INV_FQ} x {mul_cycles:.1f} + a launch), share {depth / ms:.3f}; one-thread "
                       f"floor {one:.4f} ms ({P.kernel_muls(kname, n_pairs)} Fq multiplies x {mul_cycles:.1f} cycles "
                       f"+ a launch); bound {bound:.6f} ms ({by}, {record[kname]['fq_muls']} Fq multiplies); plain "
                       f"{plain_ms:.1f} ms, host {record[kname]['host_s'] * 1e3:.1f} ms; {kname}_kernel: {build} "
                       f"({card})")
    wide, one_lane = {}, {}
    for lanes, store in ((P3_LANES, wide), (1, one_lane)):
        xa, xb, xc = (t[:, :lanes].contiguous() for t in (a, b, c))
        for op in P.OPS:
            second = {"mul": xb, "mul_by_034": xc}.get(op)
            power = 3 if op == "frobenius" else 0
            route = P.p3_route(op, lanes)
            want, plain_ms = timed(lambda: P.map_plain(op, xa, second, power))
            before = dict(P.ROUTE_LAUNCHES)
            got, _ = timed(lambda: P.f12_map(op, xa, second, power))
            err = max_abs_err((got,), (want,))
            if err:
                raise AssertionError(f"f12_map {op} at {lanes} lanes: kernel differs from the plain version")
            if P.ROUTE_LAUNCHES[route] != before[route] + 1:
                raise AssertionError(f"f12_map {op} at {lanes} lanes did not launch on the {route} route")
            ms = cuda_ms(lambda: P.f12_map(op, xa, second, power), reps=20)
            bound, by = P.bound_ms("f12_map", clock, op=op, lanes=lanes)
            depth = P.depth_floor_ms("f12_map", inline_cycles, mul_cycles, clock, launch_ms, op=op)
            levels, inverses = P.depth_levels("f12_map", op=op, power=power)
            store[op] = dict(shape=[96, lanes], p3_route=route, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound, bound_by=by, bound_share=bound / ms, depth_floor_ms=depth,
                             levels=levels, fermat_inverses=inverses)
            log("pairing", f"f12_map {op} (96, {lanes}){' power 3' if power else ''} on the {route} route: exact; "
                           f"kernel {ms:.5f} ms, bound {bound:.7f} ms ({by}), share {bound / ms:.5f}; schedule "
                           f"route's depth floor {depth:.5f} ms ({levels} levels, {inverses} Fermat inverse, a "
                           f"launch); plain {plain_ms:.2f} ms ({card})")
    record["f12_map"] = dict(one_lane["mul"], op="mul", other_ops={k: v for k, v in one_lane.items() if k != "mul"},
                             wide=wide, launches_by_route=routes,
                             build=builds.get("f12_sched_kernel", "not in the ptxas log"))
    log("pairing", f"f12_sched_kernel: {record['f12_map']['build']} ({card})")
    return launches, record


def phase_groth16(dev, card: str, log2_m: int) -> tuple:
    """`python -m kogarashi_tpu_torch.benches.groth16_large` in-process
    (`groth16_large.run`: SquareChainCircuit(2^log2_m), setup from
    random.Random(0x5E7), a proof from random.Random(0xBEEF), verify, a changed
    public input rejected), its JSON logged; then the proof encoded, decoded
    (G2 subgroup check) and verified again. Every kernel must have launched
    for G1 and G2, and K2 and K4 at every lane group of the path."""
    from kogarashi_tpu_torch.benches import groth16_large
    from kogarashi_tpu_torch.curves import G1, G2
    from kogarashi_tpu_torch.ops import ec
    from kogarashi_tpu_torch.utils.serde import decode_groth16_proof, encode_groth16_proof

    logging.basicConfig(format="[groth16] %(message)s", stream=sys.stdout)
    for name in ("kogarashi_tpu_torch.groth16.setup", "kogarashi_tpu_torch.groth16.prover"):
        logging.getLogger(name).setLevel(logging.INFO)
    ec.reset_launches()  # counts from here on are the main path's
    record, (proof, inputs, verifier) = groth16_large.run(log2_m, dev)
    launches = dict(ec.LAUNCHES)
    by_group = {k: dict(sorted(v.items())) for k, v in ec.GROUP_LAUNCHES.items()}
    data = encode_groth16_proof(proof)
    back = decode_groth16_proof(data)  # validates A, C on G1 and B in G2's r-order subgroup
    if (back.a, back.b, back.c) != (proof.a, proof.b, proof.c) or not verifier.verify(back, inputs):
        raise AssertionError("Groth16: the decoded proof differs or does not verify")
    # every kernel, every lane group of K2 (its 13 shapes span them) and K4's
    # one-lane group (the window combine's)
    want = [(f"scan_proj_{c.name}", g) for c in (G1, G2) for g in ec.groups("scan_proj", c)]
    want += [(f"map_pdouble_{c.name}", ec.lane_group("map_pdouble", c, 1)) for c in (G1, G2)]
    missing = [f"{k}_{c.name}" for k in ec.KERNELS for c in (G1, G2) if launches[f"{k}_{c.name}"] <= 0]
    missing += [f"{k} g={g}" for k, g in want if by_group.get(k, {}).get(g, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the Groth16 path: {missing}")
    log("groth16", json.dumps(record))
    log("groth16", f"SquareChainCircuit(2^{log2_m}): setup {record['setup_s']:.3f} s, prove {record['prove_s']:.3f} s, "
                   f"verify {record['verify_s']:.3f} s; verify True, tampered input rejected; the proof's {len(data)} "
                   f"bytes decode (G2 subgroup check) and verify ({card})")
    log("groth16", f"launches: {json.dumps(launches)}")
    log("groth16", f"K2 and K4 launches by lane group g: {json.dumps(by_group)}")
    return launches, by_group, (proof, inputs, verifier.vk)


def phase_distributed(card: str, msm_median_s: float) -> dict:
    """The distributed leg under NCCL with one rank per visible card, at the
    groth16 phase's domain (2^LOG2_CONSTRAINTS) and the msm phase's G1 size
    (2^LOG2_MSM; c = 16 on one rank): `dryrun_multichip` checks the H
    pipeline against the single-device pipeline and the MSM against the host
    oracle inside the ranks (a failure, or a rank that dies, raises here),
    and times each beside its single-device counterpart. Returns rank 0's
    K1-K4 launches on the distributed path."""
    import torch

    from kogarashi_tpu_torch.ops import ec
    from kogarashi_tpu_torch.parallel import dryrun_multichip

    world = torch.cuda.device_count()
    torch.cuda.empty_cache()  # the ranks share the card(s) with this process
    t0 = time.perf_counter()
    rec = dryrun_multichip(world, "nccl", "cuda", log_h=LOG2_CONSTRAINTS, log_msm=LOG2_MSM)
    wall = time.perf_counter() - t0
    missing = [f"{k}_g1" for k in ec.KERNELS if rec["launches"][f"{k}_g1"] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the distributed path: {missing}")
    mesh = f"{world}-rank mesh" + (" and a 2-D (dp, shard) one" if rec["two_d"] else "")
    log("distributed", f"nccl, {mesh} on {rec['device']}: H pipeline 2^{rec['log_h']} equal to the single-device "
                       f"Domain pipeline; G1 MSM 2^{rec['log_msm']} c={rec['c']} equal to the host oracle "
                       f"(the whole phase {wall:.3f} s, process start and NCCL set-up included; {card})")
    log("distributed", f"H pipeline 2^{rec['log_h']}: DistributedDomain tables {rec['tables_s']:.4f} s (again, warm: "
                       f"{rec['tables_warm_s']:.4f} s); first call "
                       f"{rec['h_first_s']:.4f} s; warm {[round(t, 4) for t in rec['h_s']]} s, median "
                       f"{rec['h_s_median']:.4f} s; single-device Domain pipeline {[round(t, 4) for t in rec['h_single_s']]} "
                       f"s, median {rec['h_single_s_median']:.4f} s ({card})")
    log("distributed", f"G1 MSM 2^{rec['log_msm']}: first call {rec['msm_first_s']:.4f} s; warm "
                       f"{[round(t, 4) for t in rec['msm_s']]} s, median {rec['msm_s_median']:.4f} s; single-device msm "
                       f"in the rank {[round(t, 4) for t in rec['msm_single_s']]} s, median "
                       f"{rec['msm_single_s_median']:.4f} s; the msm phase's median {msm_median_s:.4f} s (host copy "
                       f"inside) ({card})")
    log("distributed", f"launches in rank 0: {json.dumps({k: v for k, v in rec['launches'].items() if v})}; "
                       f"K2 and K4 by lane group g: {json.dumps(rec['group_launches'])}")
    return rec["launches"]


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
    2. `python -m kogarashi_tpu_torch.benches.ivc_chain` in-process
       (`ivc_chain.run`, random.Random(99) keys): setup, NOVA_STEPS steps (5
       if 10 would take the chain past NOVA_PHASE_S), its checks (the final
       proof verifies, z_i, a changed z_i rejected), its JSON; each step's
       seconds and the folding steps' split (`StepSplit`, around the steps)."""
    import hashlib

    import torch

    from kogarashi_tpu_torch import constants as C
    from kogarashi_tpu_torch.benches import ivc_chain
    from kogarashi_tpu_torch.curves import GRUMPKIN
    from kogarashi_tpu_torch.nova import ExampleFunction, Ivc, PublicParams, RelaxedR1csWitness
    from kogarashi_tpu_torch.ops import ec
    from kogarashi_tpu_torch.errors import MalformedProof
    from kogarashi_tpu_torch.pallet import NovaPallet, SamplePallet
    from kogarashi_tpu_torch.utils.serde import Codec, decode_recursive_proof, encode_recursive_proof
    from kogarashi_tpu_torch.utils.xorshift import REFERENCE_TEST_SEED, XorShiftRng

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
    data = encode_recursive_proof(proof)
    digest = hashlib.sha256(data).hexdigest()
    if not ok:
        raise AssertionError("Nova: the 3-step reference proof does not verify")
    if proof.zi_primary != ivc_chain.chain_state(proof.i):
        raise AssertionError(f"Nova: z_i {proof.zi_primary} after {proof.i} steps")
    if digest != NOVA_PROOF_DIGEST:
        raise AssertionError(f"Nova: proof digest {digest}, the JAX package's is {NOVA_PROOF_DIGEST}")
    # the pallet: the proof's bytes decode on the host and verify on the card
    if encode_recursive_proof(decode_recursive_proof(data)) != data:
        raise AssertionError("Nova: the decoded proof does not encode to the same bytes")
    t0 = time.perf_counter()
    pallet, sample = NovaPallet(), SamplePallet()
    if not pallet.verify("alice", data, pp) or pallet.events != [("ProofVerified", "alice")]:
        raise AssertionError(f"Nova: the pallet rejected the proof's bytes ({pallet.events})")
    t_pallet = time.perf_counter() - t0
    if not sample.set_thing_1("bob", 7, data, pp) or sample.thing != 7:
        raise AssertionError("Nova: SamplePallet.set_thing_1 did not set its value")
    # one byte of u_single_secondary's commitment flipped: off the curve, so
    # the decoder raises MalformedProof, as the JAX package's does
    # (tests/test_torch_serde.py decides it on the CPU)
    at = len(Codec().compact(proof.i).bytes()) + sum(
        1 + 32 * len(v) for v in (proof.z0_primary, proof.z0_secondary, proof.zi_primary, proof.zi_secondary))
    tampered = bytearray(data)
    tampered[at] ^= 1
    try:
        NovaPallet().verify("mallory", bytes(tampered), pp)
    except MalformedProof:
        pass
    else:
        raise AssertionError("Nova: the pallet took bytes with a flipped commitment byte")
    # the port's stricter check: the same proof with an empty E is rejected
    # (the JAX package's zip of E with the products would take it)
    emptied = decode_recursive_proof(data)
    emptied.w_range_primary = RelaxedR1csWitness(w=emptied.w_range_primary.w, e=[])
    if NovaPallet().verify("mallory", encode_recursive_proof(emptied), pp):
        raise AssertionError("Nova: the pallet took the proof re-encoded with w_range_primary.e = []")
    # checkpoint and resume: the proof's bytes, decoded, carry the chain on,
    # and its step 4 is the uninterrupted chain's
    t0 = time.perf_counter()
    resumed = Ivc.resume(pp, decode_recursive_proof(data)).prove_step()
    t_resumed = time.perf_counter() - t0
    step4 = ivc.prove_step()
    digest4 = hashlib.sha256(encode_recursive_proof(step4)).hexdigest()
    if hashlib.sha256(encode_recursive_proof(resumed)).hexdigest() != digest4 or resumed.i != 4:
        raise AssertionError("Nova: the chain resumed from step 3's bytes gives another step 4")
    log("nova", f"resume: Ivc.resume from the 3-step proof's decoded bytes, one prove_step ({t_resumed:.3f} s "
                f"with the decode): step 4's sha256 {digest4} = the uninterrupted chain's ({card})")
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
    log("nova", f"pallet: the proof's {len(data)} bytes decode and NovaPallet.verify accepts them "
                f"(ProofVerified) in {t_pallet:.3f} s; SamplePallet.set_thing_1 sets 7; a flipped "
                f"commitment byte raises MalformedProof; re-encoded with w_range_primary.e = [] it is "
                f"rejected ({card})")
    log("nova", f"launches: {json.dumps({k: v for k, v in launches.items() if v})}")
    log("nova", f"K2 and K4 launches by lane group g: {json.dumps(by_group)}")

    split = StepSplit()
    record, detail = ivc_chain.run(NOVA_STEPS, dev, cap_s=NOVA_PHASE_S, around_steps=split)
    steps = detail["step_s"]
    folds = len(steps) - 1  # the first step is the base case
    other = sum(steps) - sum(split.parts.values())
    per = {k: v / folds for k, v in sorted(split.parts.items())}
    per["transcripts and folds"] = other / folds
    log("nova", "ivc_chain: " + json.dumps(record))
    log("nova", f"timed chain (benches.ivc_chain.run, random.Random(99)): setup {record['setup_s']:.3f} s; steps "
                f"{[round(t, 4) for t in steps]} s; {len(steps) / sum(steps):.4f} steps/s over "
                f"{len(steps)} steps, {folds / sum(steps[1:]):.4f} over the {folds} folding steps; verify "
                f"{detail['verify_s']:.3f} s; the final proof verifies, z_i is right, a changed z_i is rejected "
                f"({card})")
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
    t_start = time.perf_counter()
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

    phase_s = {"build": time.perf_counter() - t0}

    def run(name, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        phase_s[name] = phase_s.get(name, 0.0) + time.perf_counter() - t0
        return out

    run("field", phase_field, dev, card)
    g1_msm_s, _, k2_launches = run("msm", msm_check, G1, LOG2_MSM, 16, 0xBE7C4, 1, dev, card)
    run("msm", msm_check, G2, 16, None, 0xBE7C5, 2, dev, card)
    bench_launches = run("entry and bench", phase_bench, dev, card)
    record = run("ec", phase_ec, dev, card, LOG2_MSM, windows=16, k2_launches=k2_launches)
    run("curves", phase_curves, dev, card)
    micro_launches = run("micro", phase_micro, card)
    ed_record = run("edwards", phase_edwards, dev, card)
    sig_launches, sig_by_group = run("signature", phase_signature, dev, card)
    g16_launches, g16_by_group, (proof, inputs, pvk) = run("groth16", phase_groth16, dev, card, LOG2_CONSTRAINTS)
    dist_launches = run("distributed", phase_distributed, card, g1_msm_s)
    pair_launches, pair_record = run("pairing", phase_pairing, dev, card, proof, inputs, pvk)
    paths = {"groth16": (g16_launches, g16_by_group), "nova": run("nova", phase_nova, dev, card)}

    kernels = []
    for key, rec in record.items():
        # G1's and G2's kernels belong to the Groth16 path, Grumpkin's to Nova's
        path = "nova" if key.endswith("_grumpkin") else "groth16"
        launches, by_group = paths[path]
        entry = dict(name=key, route="cuda", source=EC_SOURCE, replaces=REPLACES[key.rsplit("_", 1)[0]],
                     launches=launches[key], path=path,
                     launches_by_path={k: v[0][key] for k, v in paths.items()}, **rec)
        if key.endswith("_g1"):
            entry["launches_by_path"]["distributed"] = dist_launches[key]
            entry["launches_by_path"].update({k: v[key] for k, v in bench_launches.items()})
        entry["launches_by_path"]["micro"] = micro_launches[key]
        if key in by_group:
            entry["launches_by_g"] = by_group[key]
        kernels.append(entry)
    for key, rec in ed_record.items():
        entry = dict(name=key, route="cuda", source=ED_SOURCE, replaces=ED_REPLACES[key.rsplit("_", 1)[0]],
                     launches=sig_launches[key], path="signature",
                     launches_by_path={"signature": sig_launches[key], "micro": micro_launches[key]}, **rec)
        if key in sig_by_group:
            entry["launches_by_g"] = sig_by_group[key]
        kernels.append(entry)
    for key, rec in pair_record.items():
        kernels.append(dict(name=key, route="cuda", source=PAIR_SOURCE, replaces=PAIR_REPLACES[key],
                            launches=pair_launches[key], path="groth16_verify",
                            launches_by_path={"groth16_verify": pair_launches[key]}, library_ms=None, **rec))
    log("done", f"every phase in {time.perf_counter() - t_start:.1f} s; by phase, s: "
                f"{json.dumps({k: round(v, 1) for k, v in phase_s.items()})} ({card})")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
