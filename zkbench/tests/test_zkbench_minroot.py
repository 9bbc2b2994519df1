"""The MinRoot cell (`nova-minroot-2p16-fold`) at a size a test run holds:
on the CPU at 4 rounds a step, with commitments from the keys' discrete logs
(`dlog_commitments`), a sound run is correct and the control and each fault
(`bad_advice` among them) are not; the chain made backward is the forward
map's. The `cuda` case runs the cell on the card at its own size.
"""

from __future__ import annotations

import contextlib
import random
import time

import pytest
import torch

from zkbench import harness
from zkbench.reference import minroot as ref
from zkbench.reference.ec import Q, R

from .test_zkbench_cells import dlog_commitments

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
CELL = "nova-minroot-2p16-fold"
SEED = 2**31 + 54321  # larger than 32 signed bits hold
SMALL = {"iterations_per_step": 4, "warmup": 2}
MODES = ["control", "altered", "unchanged", "bad_advice"]


def one_run(overrides, device, mode=None):
    """A run of one request (the window closes after the first)."""
    with dlog_commitments() if device == "cpu" else contextlib.nullcontext():
        return harness.run_cell(BENCH, CELL, SEED, 1e-3, False, device, time.perf_counter(),
                                mode=mode, overrides=dict(overrides), log=lambda _: None)


@pytest.fixture
def cpu_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_backward_chain_is_the_forward_map():
    rng = random.Random(3)
    for p in (R, Q):
        end = (rng.randrange(p), rng.randrange(p))
        z0, hints = ref.chain_backward(end, 5, 3, p)
        assert ref.forward(z0, 15, p) == end and ref.backward(end, 15, p) == z0
        z = z0
        for step in hints:  # each hint is the next round's x
            for h in step:
                z = ref.forward(z, 1, p)
                assert z[0] == h
    assert ref.forward((1, 2), 0) == (1, 2)


def test_sound_run_is_correct(cpu_threads):
    res, checks = one_run(SMALL, "cpu")
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1, checks
    assert checks == [("chain_failures", 0, 0)]
    assert {"setup_s", "fold_step_s"} == set(res["metrics"])


@pytest.mark.parametrize("mode", MODES)
def test_control_and_faults_are_not_correct(mode, cpu_threads):
    res, checks = one_run(SMALL, "cpu", mode=mode)
    assert not res["correct"], (mode, checks)
    assert any(v > limit for _, v, limit in checks)


def test_window_past_the_advice_raises(cpu_threads):
    with pytest.raises(RuntimeError, match="advice_steps"):
        one_run({**SMALL, "advice_steps": 2}, "cpu")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
def test_card_sound_control_and_faults(card):
    res, checks = one_run({}, card)
    assert res["correct"] and res["device"]["platform"] == "gpu", checks
    for mode in MODES:
        res, checks = one_run({}, card, mode=mode)
        assert not res["correct"], (mode, checks)
