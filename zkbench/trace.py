"""What a traced run reads: the benchmark's spans around calls into the
program's layers, the program's own stage marks, and the device trace.

- `Spans` wraps (owner, attribute) calls in a `torch.profiler.record_function`
  range named by the layer, and for `sync` targets also times each call
  between two device synchronisations, summed by label (the method of
  `chip_smoke.py`'s `StepSplit`, copied here).
- `StageMarks` collects the INFO stage marks that `kogarashi_tpu_torch.stages`
  logs under the port's loggers (and that synchronise the card while INFO is
  on).
- `summarize` reduces a profiler trace to device busy time (the union of the
  device operations' intervals, as `profile_prove.trace_summary` takes it),
  the traced window, counts, the device operations that took most time, and
  the idle gaps by the innermost span the host was in.
"""

from __future__ import annotations

import contextlib
import logging
import time
from collections import defaultdict

import torch

WINDOW = "zkbench traced window"
REQUEST = "zkbench request"
OUTSIDE = "(no span)"
PORT_LOGGER = "kogarashi_tpu_torch"
NAME_CHARS = 120  # kernel names are C++ template signatures: their heads say enough


def sync_all() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Spans:
    def __init__(self, targets):
        self.targets = list(targets)
        self.parts: dict[str, float] = defaultdict(float)
        self.labels = {label for _, _, label, _ in self.targets} | {WINDOW, REQUEST}

    def __enter__(self):
        self.saved = []
        for owner, name, label, sync in self.targets:
            real = getattr(owner, name)
            if isinstance(owner, type):
                real = owner.__dict__.get(name, real)

            def spy(*args, real=real, label=label, sync=sync, **kw):
                with torch.profiler.record_function(label):
                    if not sync:
                        return real(*args, **kw)
                    sync_all()
                    t0 = time.perf_counter()
                    out = real(*args, **kw)
                    sync_all()
                    self.parts[label] += time.perf_counter() - t0
                    return out

            self.saved.append((owner, name, real))
            setattr(owner, name, spy)
        return self

    def __exit__(self, *exc):
        for owner, name, real in reversed(self.saved):
            setattr(owner, name, real)


class StageMarks(logging.Handler):
    """INFO marks "<what> <stage>: <seconds> s" of the port's loggers (all of
    them propagate to PORT_LOGGER), as {"<what> <stage>": [seconds, ...]},
    while entered."""

    def __init__(self, loggers=(PORT_LOGGER,)):
        super().__init__(logging.INFO)
        self.loggers = [logging.getLogger(name) for name in loggers]
        self.marks: dict[str, list[float]] = defaultdict(list)

    def emit(self, record):
        if record.msg == "%s %s: %.3f s" and len(record.args) == 3:
            what, stage, seconds = record.args
            self.marks[f"{what} {stage}"].append(float(seconds))

    def __enter__(self):
        self.saved = [(lg, lg.level, lg.propagate) for lg in self.loggers]
        for lg in self.loggers:
            lg.addHandler(self)
            lg.setLevel(logging.INFO)
            lg.propagate = False
        return self

    def __exit__(self, *exc):
        for lg, level, propagate in self.saved:
            lg.removeHandler(self)
            lg.setLevel(level)
            lg.propagate = propagate


def _union(intervals):
    """Sorted, merged [start, end] intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(prof, labels) -> dict:
    """Busy and window seconds, kernel and memory-operation counts, and the
    breakdown, from a profile whose window is the range WINDOW."""
    events = prof.events()
    cpu_spans, device = [], []
    window = None
    for e in events:
        kind = e.device_type
        if kind == torch.autograd.DeviceType.CPU:
            if e.name == WINDOW:
                window = (e.time_range.start, e.time_range.end)
            elif e.name in labels:
                cpu_spans.append((e.time_range.start, e.time_range.end, e.name))
        elif kind == torch.autograd.DeviceType.CUDA and e.name not in labels and e.name != WINDOW:
            device.append((e.time_range.start, e.time_range.end, e.name))
    if window is None or not device:
        return {}
    busy = _union((s, e) for s, e, _ in device)
    lo = min(window[0], busy[0][0])
    hi = max(window[1], busy[-1][1])
    busy_us = sum(e - s for s, e in busy)

    by_name = defaultdict(float)
    memops = 0
    for s, e, name in device:
        by_name[name] += e - s
        memops += name.startswith(("Memcpy", "Memset"))

    # idle gaps, each put to the innermost span open at its middle
    gaps = [(a, b) for a, b in zip([lo] + [e for _, e in busy], [s for s, _ in busy] + [hi]) if b > a]
    # (the spans come from one thread, so they nest: a stack sweep finds it)
    cpu_spans.sort(key=lambda t: (t[0], -t[1]))
    idle = defaultdict(float)
    stack, j = [], 0
    for a, b in gaps:
        mid = (a + b) / 2
        while j < len(cpu_spans) and cpu_spans[j][0] <= mid:
            while stack and stack[-1][1] < cpu_spans[j][0]:
                stack.pop()
            stack.append(cpu_spans[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        idle[stack[-1][2] if stack else OUTSIDE] += b - a
    top = lambda d: [[name[:NAME_CHARS], us / 1e6] for name, us in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"busy_s": busy_us / 1e6, "window_s": (hi - lo) / 1e6, "kernels": len(device) - memops,
            "memops": memops, "device_ops": top(by_name), "idle_gaps": top(idle)}


@contextlib.contextmanager
def profiled():
    """A torch.profiler session over CPU ranges and device operations."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
