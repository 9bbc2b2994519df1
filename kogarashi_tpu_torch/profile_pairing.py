"""Time P1 (`pair_miller_loop`) and P2 (`pair_final_exp`) at every block size on one GPU.

    python3 -m kogarashi_tpu_torch.profile_pairing

Builds csrc/pairing.cu once per block size in THREADS (-DKT_PAIR_T, one nvcc
each, all started together, each into its own library), runs P1 on three
pairs and P2 on their Miller loop through each, checks each result exactly
against the package's build (which chip_smoke.py holds to the plain
versions), and times each (`ec.device_ms`, mean of 10 calls in a row). The
package launches csrc/pairing.cu's `kPairT`; this is how it was picked. The
card (nvidia-smi name, power limit) is printed on its own line, and one JSON
object with every number as the last line. Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import sys

import torch

from . import pyref
from .ops import _build, ec
from .ops import pairing as P
from .ops import pairing_schedule as schedule
from .pyref.pairing_fast import G2Prepared

THREADS = (32, 64, 96)
PAIRS = ((5, 7), (11, 13), (17, 19))  # (a, b): the pairs (a G1, b G2)


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


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_pairing: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    name = card()
    libs = build_libs()
    g1, g2 = pyref.G1_SPEC.generator, pyref.G2_SPEC.generator
    coeffs = P._encode_prepared([(a * g1, G2Prepared.from_affine(b * g2)) for a, b in PAIRS], dev)
    ml = P.miller_loop_coeffs(coeffs)
    ml_sched, fe_sched = schedule.miller_loop(len(PAIRS)), schedule.final_exp()
    ml_tab, fe_tab = (torch.from_numpy(s.table).to(dev) for s in (ml_sched, fe_sched))
    runs = {
        "pair_miller_loop": (ml, lambda lib, out, s: lib.kt_pair_miller_loop(
            ml_tab.data_ptr(), coeffs.data_ptr(), ml_sched.n_lines(), ml_sched.smem_bytes(), out.data_ptr(), s)),
        "pair_final_exp": (P.final_exp_device(ml), lambda lib, out, s: lib.kt_pair_final_exp(
            fe_tab.data_ptr(), ml.data_ptr(), fe_sched.smem_bytes(), out.data_ptr(), s)),
    }
    record = {"package_threads": P.pair_threads()}
    for kname, (want, launch) in runs.items():
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
        record[kname] = ms
        print(f"{kname}: exact at " + ", ".join(f"T = {t}: {v:.4f} ms" for t, v in ms.items())
              + f"; the package launches T = {record['package_threads']} ({name})", flush=True)
    print(name, flush=True)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
