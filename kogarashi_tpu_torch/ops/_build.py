"""Build and load the CUDA kernels (csrc/*.cu) at first use.

Each source is compiled by its own `nvcc -gencode arch=compute_90a,code=sm_90a
-O3 -Xcompiler -fPIC -c`, all started together, and the objects are linked
into one shared library with a plain C interface, cached in
`kogarashi_tpu_torch/_build/` under a hash of the sources and flags; the
library is loaded with `ctypes`. A failed build or load raises. Nothing here
runs at import time.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
ARCH = "arch=compute_90a,code=sm_90a"

_LIB = None

P = ctypes.c_void_p
I = ctypes.c_int
_SIGNATURES = {
    "kt_scan_mixed_{c}": [P, P, P, P, P, I, I, P],
    "kt_scan_proj_{c}": [P, P, P, P, P, P, I, I, I, P],
    "kt_map_padd_{c}": [P, P, P, P, P, P, P, P, P, I, P],
    "kt_map_pdouble_{c}": [P, P, P, P, P, P, I, I, I, P],
}
_ED_SIGNATURES = {  # csrc/edwards.cu, per Edwards curve
    "kt_ed_scalar_mul_{c}": [P, P, P, P, I, P, P, P, P, P, I, P],
    "kt_ed_map_add_{c}": [P] * 12 + [I, I, P],
    "kt_ed_map_double_{c}": [P] * 8 + [I, I, P],
}
_PAIR_SIGNATURES = {  # csrc/pairing.cu
    "kt_pair_miller_loop": [P, P, I, I, P, P],
    "kt_pair_final_exp": [P, P, P, I, P, P],
    "kt_f12_map": [I, P, P, P, I, P, I, P],
}
_FIELD_SIGNATURE = [P, P, P, I, I, P]
_PROBE_SIGNATURES = {"kt_imad_probe_info": [I, P], "kt_imad_probe": [I, I, I, P, P, P],
                     "kt_mul_latency": [I, I, P, P, P], "kt_empty": [P],
                     "kt_spin": [ctypes.c_longlong, P]}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _cuda_tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / name
    if cand.exists():
        return str(cand)
    raise RuntimeError(f"{name} not found: the CUDA kernels cannot be built")


def source_hash() -> str:
    h = hashlib.sha256(ARCH.encode())
    for f in _sources():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile csrc/*.cu into _build/libkt_<hash>.so unless it exists."""
    key = source_hash()
    lib = BUILD / f"libkt_{key}.so"
    log = BUILD / f"libkt_{key}.ptxas.txt"
    if lib.exists():
        return lib
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _cuda_tool("nvcc")
    common = [nvcc, "-gencode", ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
    tag = f"{key}.{os.getpid()}"
    objs, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD / f".{src.stem}_{tag}.o"
        objs.append(obj)
        procs.append(subprocess.Popen([*common, "-Xptxas", "-v", "-c", "-o", str(obj), str(src)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate()[0] for p in procs]
    failed = [(p.returncode, o) for p, o in zip(procs, outs) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"nvcc failed ({failed[0][0]}):\n{failed[0][1][-8000:]}")
    tmp = BUILD / f".libkt_{tag}.so"
    res = subprocess.run([*common, "-shared", "-o", str(tmp), *map(str, objs)],
                         capture_output=True, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr[-8000:]}")
    log.write_text("".join(outs))
    os.replace(tmp, lib)
    return lib


def ptxas_report() -> list[str]:
    """One line per kernel: registers, spill stores/loads and stack, from the
    `-Xptxas -v` log of the current build."""
    log = BUILD / f"libkt_{source_hash()}.ptxas.txt"
    if not log.exists():
        return []
    out, name, spill = [], None, ("?", "?", "?")
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spill = m.groups()
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{_demangle(name)}: {m.group(1)} registers, stack {spill[0]} B, "
                       f"spill stores {spill[1]} B, spill loads {spill[2]} B")
            name = None
    return out


def sass_report() -> list[str]:
    """One line per kernel of the current build: SASS instructions, and the
    IMAD-class ones (IMAD, IMAD.WIDE, IMAD.HI, ...), from `cuobjdump -sass`.
    Straight-line counts: a loop body counts once."""
    res = subprocess.run([_cuda_tool("cuobjdump"), "-sass", str(build())],
                         capture_output=True, text=True, check=True)
    counts: dict = collections.OrderedDict()
    name = None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = _demangle(m.group(1))
            counts[name] = collections.Counter()
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)(\.[A-Z0-9_.]+)?", line)
        if m and name:
            counts[name]["all"] += 1
            counts[name][m.group(1)] += 1
            if m.group(1) == "IMAD" and (m.group(2) or "").startswith((".WIDE", ".MOV")):
                counts[name]["IMAD." + m.group(2).split(".")[1]] += 1
    return [f"{k}: {c['all']} instructions, IMAD {c['IMAD']} (WIDE {c['IMAD.WIDE']}, "
            f"MOV {c['IMAD.MOV']}), IADD3 {c['IADD3']}, SEL {c['SEL']}, SHFL {c['SHFL']}, "
            f"LDG {c['LDG']}, LDGSTS {c['LDGSTS']}, LDS {c['LDS']}, STS {c['STS']}, STG {c['STG']}"
            for k, c in counts.items()]


def _demangle(name: str) -> str:
    for kern in ("scan_mixed_kernel", "scan_proj_group_kernel", "scan_proj_kernel",
                 "pdouble_group_kernel", "padd_kernel", "pdouble_kernel", "field_op_kernel",
                 "ed_scalar_mul_kernel", "ed_map_add_kernel", "ed_map_double_kernel",
                 "pair_miller_loop_kernel", "pair_final_exp_kernel", "f12_map_kernel",
                 "fp_mul_call", "imad_wide_probe_kernel", "imad_probe_kernel",
                 "mul_latency_kernel", "empty_kernel", "spin_kernel"):
        if kern in name:
            tags = [t for t in ("G1", "G2", "Grumpkin", "Jubjub", "Fq", "BlsFr", "Fr") if t in name]
            if "BlsFr" in tags:
                tags.remove("Fr")
            tags += re.findall(r"Li(\d+)E", name) + re.findall(r"Lb([01])E", name)
            return f"{kern}<{','.join(tags)}>" if tags else kern
    return name


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        path = build()
        handle = ctypes.CDLL(str(path))
        for curve in ("g1", "g2", "grumpkin"):
            for fmt, args in _SIGNATURES.items():
                fn = getattr(handle, fmt.format(c=curve))
                fn.argtypes = args
                fn.restype = ctypes.c_int
        for fmt, args in _ED_SIGNATURES.items():
            fn = getattr(handle, fmt.format(c="jubjub"))
            fn.argtypes = args
            fn.restype = ctypes.c_int
        for fname, args in _PAIR_SIGNATURES.items():
            fn = getattr(handle, fname)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        for fld in ("fq", "fr", "blsfr"):
            fn = getattr(handle, f"kt_field_op_{fld}")
            fn.argtypes = _FIELD_SIGNATURE
            fn.restype = ctypes.c_int
        for fname, args in _PROBE_SIGNATURES.items():
            fn = getattr(handle, fname)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _LIB = handle
    return _LIB


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {rc}")
