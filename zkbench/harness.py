"""One run of one cell: find its files by name, set up, drive the closed loop
for the window, check the answers against the plain reference, read the
metrics.

The window opens with the first timed request and closes when the first
request that ends after `seconds` have passed completes; a rate or a time
per request divides by that whole window and counts every request
completed in it. A traced run (`trace`) profiles the first
`trace_requests` requests of the window (the traffic mix says how many) and
reads the per-layer metrics from them; the rest of the window runs
untraced, and its answers are checked like the others. In the traced
requests the calls that the cell's per-layer metrics name in their `SPANS`
are wrapped in spans, and the port's stage marks are on.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from . import trace as tr
from .drivers.common import sync

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "kogarashi_tpu")
ONE_CLIENT = {"loop": "closed", "clients": 1}  # the only load the harness offers


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def cell_spec(bench: dict, name: str):
    """(cell, config, traffic, end_to_end, per_layer) for the cell `name`:
    the metric entries of BENCHMARK.json that this cell reports."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json (cells: {', '.join(cells)})")
    cell = cells[name]
    config = load_json(HERE / "configs" / f"{cell['config']}.json")
    traffic = one_client(load_json(HERE / "traffic" / f"{cell['traffic']}.json"))
    mine = lambda metrics: [m for m in metrics if name in m.get("workloads", [name])]
    return cell, config, traffic, mine(bench["end_to_end"]), mine(bench["per_layer"])


def metric_module(metric: str):
    """metrics/<metric>.py: its `read(run)`, and the `SPANS` a traced run
    wraps for it, if it names any."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"zkbench.metrics.{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def one_client(traffic: dict) -> dict:
    """The mix, if it asks for no other load than the one the harness offers."""
    for key, value in ONE_CLIENT.items():
        if traffic.get(key, value) != value:
            raise ValueError(f"the mix asks for {key} {traffic[key]!r}; the harness drives only {ONE_CLIENT}")
    return traffic


def reader(metric: str):
    return metric_module(metric).read


def resolve(target: str):
    """"package.module:Owner.attr" or "package.module:attr" -> (owner, attr)."""
    module, _, path = target.partition(":")
    owner = importlib.import_module(module)
    *parents, attr = path.split(".")
    for name in parents:
        owner = getattr(owner, name)
    if not callable(getattr(owner, attr)):
        raise TypeError(f"{target} is not callable")
    return owner, attr


def spans_of(metrics) -> list:
    """The (owner, attribute, label, sync) calls that the metrics' `SPANS`
    name, each target once (synchronised if any metric asks for it)."""
    found = {}
    for m in metrics:
        for target, label, sync in getattr(metric_module(m["name"]), "SPANS", ()):
            first_label, first_sync = found.get(target, (label, False))
            found[target] = (first_label, first_sync or sync)
    return [(*resolve(target), label, sync) for target, (label, sync) in found.items()]


def driver_class(traffic: dict):
    return importlib.import_module(f"zkbench.drivers.{traffic['driver']}").Driver


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


@dataclass
class Run:
    """What the metric readers read."""

    setup_s: float = 0.0
    window_s: float = 0.0
    latencies: list = field(default_factory=list)
    work: float | None = None  # nominal work units of one request
    io_bytes: float | None = None  # bytes one request must read and write
    traced_requests: int = 0
    marks: dict = field(default_factory=dict)  # stage -> [seconds per traced request]
    parts: dict = field(default_factory=dict)  # span label -> seconds over the traced requests
    device: dict = field(default_factory=dict)  # summarize() of the trace

    @property
    def completed(self) -> int:
        return len(self.latencies)

    def idle_share(self):
        d = self.device
        return 1 - d["busy_s"] / d["window_s"] if d else None


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, mode: str | None = None, overrides: dict | None = None, log=print):
    """Returns (result, checks): the result line's object without "checks",
    and [(name, value, limit)]. `mode` is None, "control" or a fault's name;
    `overrides` updates the config and traffic (tests run small sizes)."""
    cell, config, traffic, e2e, per_layer = cell_spec(bench, name)
    for key, value in (overrides or {}).items():
        (config if key in config else traffic)[key] = value
    drv = driver_class(traffic)(config, traffic, seed, device)
    targets = spans_of(per_layer) if trace else []
    on_card = torch.device(device).type == "cuda"
    wrap = drv.control() if mode == "control" else contextlib.nullcontext()
    run = Run(work=drv.work, io_bytes=getattr(drv, "io_bytes", None))
    answers = []
    with wrap:
        drv.setup()
        broken = drv.fault(mode) if mode not in (None, "control") else contextlib.nullcontext()
        with broken:
            sync(device)
            run.setup_s = time.perf_counter() - t_start
            log(f"# setup_s {run.setup_s:.3f}")
            n_traced = traffic["trace_requests"] if trace else 0
            prof = None
            i = 0
            t_window = time.perf_counter()
            while True:
                if i == 0 and n_traced:
                    spans = tr.Spans(targets)
                    marks = tr.StageMarks()
                    stack = contextlib.ExitStack()
                    prof = stack.enter_context(tr.profiled())
                    stack.enter_context(spans)
                    stack.enter_context(marks)
                    stack.enter_context(torch.profiler.record_function(tr.WINDOW))
                t0 = time.perf_counter()
                with torch.profiler.record_function(tr.REQUEST) if i < n_traced else contextlib.nullcontext():
                    answers.append(drv.request(i))
                t1 = time.perf_counter()
                run.latencies.append(t1 - t0)
                i += 1
                if i == n_traced:
                    stack.close()
                    run.traced_requests = i
                if t1 - t_window >= seconds and i >= n_traced:
                    break
            run.window_s = t1 - t_window
    lat = run.latencies
    shown = lat if len(lat) <= 60 else [min(lat), *statistics.quantiles(lat, n=10), max(lat)]
    log(f"# window {run.window_s:.3f}s, {run.completed} requests; request s "
        f"{'each' if len(lat) <= 60 else 'min, deciles, max'}: {[round(x, 4) for x in shown]}")
    memory = torch.cuda.max_memory_allocated() if on_card else 0
    if prof is not None:
        run.marks, run.parts = dict(marks.marks), dict(spans.parts)
        run.device = tr.summarize(prof, spans.labels)
        prof = None
    drv.release()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks, failed = drv.check(answers)
    log(f"# reference check {time.perf_counter() - t_check:.3f}s")

    metrics = {}
    for m in (per_layer if trace else e2e):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": all(v <= limit for _, v, limit in checks),
        "attempted": run.completed,
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": cell["chips"], "memory_peak_bytes": memory},
    }
    if trace and run.device:
        result["device"].update(busy_s=run.device["busy_s"], window_s=run.device["window_s"])
        result["breakdown"] = {"device_ops": run.device["device_ops"], "idle_gaps": run.device["idle_gaps"]}
    return result, checks

