"""Run one cell of the benchmark on this machine's card.

    python3 -m zkbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the cell's metrics as one JSON line on stdout (the end-to-end ones,
or with --trace 1 the per-layer ones), after the numbers that decided
`correct` on stderr. Exits non-zero without a result when no CUDA device
(or fewer than the cell's chips) is found, or when JAX, flax or the JAX
package was loaded. `--mode control` runs the reference at a lower
precision in the program's place, `--mode <fault>` breaks the timed path;
both must come out not correct, and the benchmark's own runs use neither.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache at a fixed path inside the checkout
CACHE = ROOT / ".zkbench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")

import torch  # noqa: E402

from zkbench import harness  # noqa: E402


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--mode", default=None, help="control, or a fault's name (checks of the check)")
    args = ap.parse_args(argv)
    if not 0 < args.seconds <= 3600:
        ap.error("--seconds must lie in (0, 3600]")

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    chips = next((w["chips"] for w in bench["workloads"] if w["name"] == args.workload), None)
    if chips is None:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    log = lambda msg: print(msg, file=sys.stderr, flush=True)
    result, checks = harness.run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                                      "cuda", T_START, mode=args.mode, log=log)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded modules that the benchmark must not load: {', '.join(bad)}", file=sys.stderr)
        return 3
    result["card"] = card()
    result["checks"] = {name: {"value": v, "limit": limit} for name, v, limit in checks}
    log(f"# card {result['card']}")
    for name, v, limit in checks:
        log(f"check {name} = {v} (limit {limit})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
