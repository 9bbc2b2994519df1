"""Build and load the CUDA kernels (csrc/*.cu) at first use.

`nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC`
compiles every source into one shared library with a plain C interface,
cached in `kogarashi_tpu_torch/_build/` under a hash of the sources; the
library is loaded with `ctypes`. A failed build or load raises. Nothing here
runs at import time.
"""

from __future__ import annotations

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
    "kt_scan_proj_{c}": [P, P, P, P, P, P, I, I, P],
    "kt_map_padd_{c}": [P, P, P, P, P, P, P, P, P, I, P],
    "kt_map_pdouble_{c}": [P, P, P, P, P, P, I, I, P],
}
_FIELD_SIGNATURE = [P, P, P, I, I, P]


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


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
    tmp = BUILD / f".libkt_{key}.{os.getpid()}.so"
    cmd = [
        _nvcc(), "-gencode", ARCH, "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp),
        *[str(f) for f in sorted(CSRC.glob("*.cu"))],
    ]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr[-8000:]}")
    log.write_text(res.stdout + res.stderr)
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


def _demangle(name: str) -> str:
    for kern in ("scan_kernel", "padd_kernel", "pdouble_kernel", "field_op_kernel"):
        if kern in name:
            tags = [t for t in ("G1", "G2", "Fq", "Fr") if t in name]
            if kern == "scan_kernel":
                tags.append("mixed" if "Lb1E" in name else "proj")
            return f"{kern}<{','.join(tags)}>"
    return name


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        path = build()
        handle = ctypes.CDLL(str(path))
        for curve in ("g1", "g2"):
            for fmt, args in _SIGNATURES.items():
                fn = getattr(handle, fmt.format(c=curve))
                fn.argtypes = args
                fn.restype = ctypes.c_int
        for fld in ("fq", "fr"):
            fn = getattr(handle, f"kt_field_op_{fld}")
            fn.argtypes = _FIELD_SIGNATURE
            fn.restype = ctypes.c_int
        _LIB = handle
    return _LIB


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {rc}")
