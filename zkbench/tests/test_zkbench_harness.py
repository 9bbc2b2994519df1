"""The harness finds every cell's files and every metric's reader by name,
and its trace reduction and readers compute what they say (CPU only)."""

from __future__ import annotations

import importlib
import json
import logging
import re
from types import SimpleNamespace

import pytest
import torch

from kogarashi_tpu_torch.stages import Stages

from zkbench import harness, trace
from zkbench.roofline import g1_msm_bytes, msm_bound_s

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    spec, config, traffic, e2e, per_layer = harness.cell_spec(BENCH, cell)
    assert config["name"] == spec["config"]
    assert hasattr(harness.driver_class(traffic), "__init__")
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2, names
    assert per_layer, "every cell reports a per-layer metric"
    entry = next(c for c in BENCH["configs"] if c["name"] == spec["config"])
    assert (harness.ROOT / entry["file"]).is_file()
    assert entry["reduced"] == config["reduced"]


@pytest.mark.parametrize("metric", METRICS)
def test_metric_reader_found_by_name(metric):
    assert NAME.match(metric)
    assert callable(harness.reader(metric))


def test_per_layer_metrics_move_a_metric_their_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in CELLS
            assert cell in moved.get("workloads", CELLS), (m["name"], cell)


SPANNED = [m for m in METRICS if getattr(harness.metric_module(m), "SPANS", ())]


@pytest.mark.parametrize("metric", SPANNED)
def test_metric_spans_name_calls_of_the_port(metric):
    for target, label, sync in harness.metric_module(metric).SPANS:
        assert target.startswith("kogarashi_tpu_torch.") and ":" in target
        owner, attr = harness.resolve(target)
        assert callable(getattr(owner, attr)) and label and isinstance(sync, bool)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_cell_collects_its_metrics_spans_once(cell):
    per_layer = harness.cell_spec(BENCH, cell)[4]
    got = harness.spans_of(per_layer)
    declared = {t for m in per_layer for t, _, _ in getattr(harness.metric_module(m["name"]), "SPANS", ())}
    assert len(got) == len(declared)
    assert len({(id(owner), attr) for owner, attr, _, _ in got}) == len(got)


def test_spans_of_keeps_a_target_synchronised_if_any_metric_asks(monkeypatch):
    modules = {"a": SimpleNamespace(SPANS=[("kogarashi_tpu_torch.ops.msm:msm", "x", False)]),
               "b": SimpleNamespace(SPANS=[("kogarashi_tpu_torch.ops.msm:msm", "y", True)])}
    monkeypatch.setattr(harness, "metric_module", modules.__getitem__)
    (got,) = harness.spans_of([{"name": "a"}, {"name": "b"}])
    assert got[1:] == ("msm", "x", True)


@pytest.mark.parametrize("load", [{"clients": 4}, {"loop": "open"}])
def test_a_mix_asking_for_other_load_is_refused(load):
    with pytest.raises(ValueError):
        harness.one_client({"driver": "msm", **load})
    assert harness.one_client({"driver": "msm", "clients": 1, "loop": "closed"})


def test_stage_marks_read_every_logger_of_the_port():
    lg = logging.getLogger("kogarashi_tpu_torch.some.module")
    with trace.StageMarks() as marks:
        st = Stages(lg, "prove", "cpu")
        st.mark("witness (host)")
    Stages(lg, "prove", "cpu").mark("after")  # off again: nothing read
    assert list(marks.marks) == ["prove witness (host)"]
    assert not logging.getLogger(trace.PORT_LOGGER).handlers


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.cell_spec(BENCH, "no-such-cell")


def _event(name, kind, start, end):
    return SimpleNamespace(name=name, device_type=kind,
                           time_range=SimpleNamespace(start=start, end=end))


def test_summarize_busy_union_and_idle_labels():
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = [
        _event(trace.WINDOW, cpu, 0, 100),
        _event("outer", cpu, 0, 100),
        _event("inner", cpu, 40, 60),
        _event("k1", cuda, 10, 30), _event("k2", cuda, 20, 35),  # overlap: 25 us busy
        _event("Memcpy DtoH", cuda, 70, 80),
        _event("inner", cuda, 40, 60),  # the range's own annotation: not device work
    ]
    d = trace.summarize(SimpleNamespace(events=lambda: events), {"outer", "inner", trace.WINDOW})
    assert d["busy_s"] == pytest.approx(35e-6)
    assert d["window_s"] == pytest.approx(100e-6)
    assert (d["kernels"], d["memops"]) == (2, 1)
    idle = dict(d["idle_gaps"])
    # gaps 0-10 and 80-100 lie in "outer", 35-70 (middle 52.5) in "inner"
    assert idle["inner"] == pytest.approx(35e-6)
    assert idle["outer"] == pytest.approx(30e-6)
    assert d["device_ops"][0] == ["k1", pytest.approx(20e-6)]


def test_readers_on_a_run():
    run = harness.Run(setup_s=12.5, window_s=10.0, latencies=[0.04] * 95 + [0.09] * 5,
                      work=1 << 24, io_bytes=g1_msm_bytes(1 << 20), traced_requests=4,
                      marks={"prove witness (host)": [1.0, 3.0], "prove MSM h (G1)": [0.1, 0.1],
                             "prove MSM b (G2)": [0.2, 0.4]},
                      parts={"synthesis": 8.0, "commit": 1.0},
                      device={"busy_s": 0.04, "window_s": 0.2, "kernels": 9200})
    read = lambda name: harness.reader(name)(run)
    assert read("setup_s") == 12.5
    assert read("prove_s") == read("fold_step_s") == pytest.approx(0.1)
    assert read("msm_point_adds_per_s") == pytest.approx(100 * (1 << 24) / 10.0)
    assert read("msm_p95_s") == 0.04
    assert read("prove.witness_s") == 2.0
    assert read("prove.msm_s") == pytest.approx(0.4)
    assert read("prove.h_poly_s") is None
    assert read("fold.synthesis_s") == 2.0
    assert read("fold.cross_term_s") is None
    assert read("msm.launches") == 2300
    assert read("idle_share.msm") == pytest.approx(0.8)
    assert read("msm_roofline") == pytest.approx(100 * msm_bound_s(1 << 24, g1_msm_bytes(1 << 20)) / 0.01)
    assert msm_bound_s(1 << 24, g1_msm_bytes(1 << 20)) == pytest.approx(2.9127e-3, rel=1e-4)


def test_readers_find_nothing_in_an_untraced_run():
    run = harness.Run(setup_s=1.0, window_s=1.0, latencies=[1.0])
    for m in BENCH["per_layer"]:
        assert harness.reader(m["name"])(run) is None, m["name"]


def test_benchmark_json_keeps_to_its_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    names = CELLS + METRICS + [c["name"] for c in BENCH["configs"]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    importlib.import_module("zkbench.run")
