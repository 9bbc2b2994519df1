"""Time P1 and P2 at every block size, and P3 (`f12_map`) on both routes, on one GPU.

    python3 -m kogarashi_tpu_torch.profile_pairing [--baseline DIR]

Builds csrc/pairing.cu once per block size in THREADS (-DKT_PAIR_T, one nvcc
each, all started together, each into its own library), runs P1 on three
pairs and P2 on their Miller loop through each, checks each result exactly
against the package's build (which chip_smoke.py holds to the plain
versions), and times each (`ec.device_ms`, mean of 10 calls in a row). The
package launches csrc/pairing.cu's `kPairT`; this is how it was picked.

Then P3: every op (frobenius at power 3) at each lane count of P3_LANES on
both routes (`ops/pairing.py` ROUTES: the op's schedule on a block a lane,
one thread a lane), each checked exactly against the plain version and
timed, beside the route the package's rule (`P3_ROUTES`, which comes from
these times) picks.

--baseline DIR: also P1, P2 and P3 (at one lane and 2^16 lanes) through the
package of another checkout in DIR (its own build and its own default
launch; for example the parent commit unpacked with `git archive`), on the
same inputs, held to the same results. The card (nvidia-smi name, power
limit) is printed on its own line, and one JSON object with every number as
the last line. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

from . import pyref
from .fields.spec import FQ
from .ops import _build, ec
from .ops import pairing as P
from .ops import pairing_schedule as schedule
from .profile_lanes import _load_package
from .pyref.pairing_fast import G2Prepared

THREADS = (32, 64, 96)
PAIRS = ((5, 7), (11, 13), (17, 19))  # (a, b): the pairs (a G1, b G2)
P3_LANES = (1, 4, 16, 64, 256, 512, 1024, 2048, 3072, 4096, 5120, 6144, 8192, 16384, 1 << 16)
P3_BASELINE_LANES = (1, 1 << 16)


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def build_libs() -> dict:
    """{T: csrc/pairing.cu built with KT_PAIR_T = T, loaded}."""
    src = _build.CSRC / "pairing.cu"
    key = hashlib.sha256(_build.ARCH.encode() + src.read_bytes()
                         + (_build.CSRC / "field.cuh").read_bytes()).hexdigest()[:16]
    _build.BUILD.mkdir(parents=True, exist_ok=True)
    libs = {t: _build.BUILD / f"libkt_pair_t{t}_{key}.so" for t in THREADS}
    procs = {}
    for t, lib in libs.items():
        if not lib.exists():
            tmp = lib.with_name(f".{lib.name}.{os.getpid()}")
            procs[t] = (tmp, subprocess.Popen(
                [_build._cuda_tool("nvcc"), "-gencode", _build.ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 f"-DKT_PAIR_T={t}", "-shared", "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for t, (tmp, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc with KT_PAIR_T={t} failed ({proc.returncode}):\n{out[-8000:]}")
        os.replace(tmp, libs[t])
    handles = {}
    for t, lib in libs.items():
        handle = ctypes.CDLL(str(lib))
        for name, args in _build._PAIR_SIGNATURES.items():
            getattr(handle, name).argtypes = args
            getattr(handle, name).restype = ctypes.c_int
        if handle.kt_pair_threads() != t:
            raise AssertionError(f"the build for {t} threads launches {handle.kt_pair_threads()}")
        handles[t] = handle
    return handles


def fq_words(n: int, seed: int, dev, rows: int = 96):
    """(rows, n) canonical Fq words: each component's top word below q's."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    w = torch.randint(-(1 << 31), 1 << 31, (rows // 8, 8, n), dtype=torch.int64, generator=gen)
    w[:, 7] = torch.randint(0, FQ.p >> 224, (rows // 8, n), generator=gen)
    return w.to(torch.int32).reshape(rows, n).to(dev)


def p3_sweep(dev, log, baseline=None) -> list:
    """P3 at every op and lane count of P3_LANES on both routes, and with
    `baseline` (another package's ops.pairing) its default launch at
    P3_BASELINE_LANES, each held exactly to the plain version."""
    top = max(P3_LANES)
    a, b, c = fq_words(top, 1, dev), fq_words(top, 2, dev), fq_words(top, 3, dev, rows=48)
    out = []
    for n in P3_LANES:
        xa, xb, xc = (t[:, :n].contiguous() for t in (a, b, c))
        for op in P.OPS:
            second = {"mul": xb, "mul_by_034": xc}.get(op)
            power = 3 if op == "frobenius" else 0
            want = P.map_plain(op, xa, second, power)
            runs = {route: (lambda route=route: P.f12_map(op, xa, second, power, route=route)) for route in P.ROUTES}
            if baseline is not None and n in P3_BASELINE_LANES:
                runs["baseline"] = lambda: baseline.f12_map(op, xa, second, power)
            ms = {}
            for name, fn in runs.items():
                if not torch.equal(fn(), want):
                    raise AssertionError(f"f12_map {op} at {n} lanes, {name}: differs from the plain version")
                ms[name] = ec.device_ms(fn, dev, 20 if n < top else 5)
            rule = P.p3_route(op, n)
            out.append(dict(op=op, lanes=n, rule_route=rule, ms=ms))
            log(f"f12_map {op} (96, {n}): exact; " + ", ".join(f"{k} {v:.5f}" for k, v in ms.items())
                + f" ms; the rule takes the {rule} route")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, help="root of another checkout to time beside this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_pairing: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    name = card()
    print(name, flush=True)

    def log(msg):
        print(f"[pairing] {msg} ({name})", flush=True)

    libs = build_libs()
    baseline = None
    if args.baseline:
        _, _, bbuild = _load_package(args.baseline.resolve())
        baseline = importlib.import_module("baseline_kt.ops.pairing")
        bbuild.lib()
    g1, g2 = pyref.G1_SPEC.generator, pyref.G2_SPEC.generator
    coeffs = P._encode_prepared([(a * g1, G2Prepared.from_affine(b * g2)) for a, b in PAIRS], dev)
    ml = P.miller_loop_coeffs(coeffs)
    ml_sched, fe_sched = schedule.miller_loop(len(PAIRS)), schedule.final_exp()
    ml_tab, fe_tab = (torch.from_numpy(s.table).to(dev) for s in (ml_sched, fe_sched))
    runs = {
        "pair_miller_loop": (ml, lambda lib, out, s: lib.kt_pair_miller_loop(
            ml_tab.data_ptr(), coeffs.data_ptr(), ml_sched.n_lines(), ml_sched.smem_bytes(), out.data_ptr(), s),
            lambda: baseline.miller_loop_coeffs(coeffs)),
        "pair_final_exp": (P.final_exp_device(ml), lambda lib, out, s: lib.kt_pair_final_exp(
            fe_tab.data_ptr(), ml.data_ptr(), fe_sched.smem_bytes(), out.data_ptr(), s),
            lambda: baseline.final_exp_device(ml)),
    }
    record = {"package_threads": P.pair_threads()}
    for kname, (want, launch, base) in runs.items():
        out = torch.empty(96, dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        ms = {}
        for t, lib in libs.items():
            def run():
                _build.check(launch(lib, out, stream), f"{kname} at {t} threads")

            run()
            if not torch.equal(out, want):
                raise AssertionError(f"{kname} at {t} threads differs from the package's build")
            ms[t] = ec.device_ms(run, dev, 10)
        if baseline is not None:
            if not torch.equal(base(), want):
                raise AssertionError(f"{kname}: the baseline differs from the package")
            ms["baseline"] = ec.device_ms(base, dev, 10)
        record[kname] = ms
        log(f"{kname}: exact at " + ", ".join(f"T = {t}: {v:.4f} ms" for t, v in ms.items())
            + f"; the package launches T = {record['package_threads']}")
    record["f12_map"] = p3_sweep(dev, log, baseline)
    record["card"] = name
    print(name, flush=True)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
