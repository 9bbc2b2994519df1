"""Each cell's loop and reference at a size a test run holds: a sound run is
correct (the reference agrees with the port), and the control and every
fault the cell can have come out not correct.

On the CPU the port runs its kernels' plain versions: MSMs of 2^8 points and
a 2^3-constraint Groth16 circuit. Nova's augmented circuits have one size
(76934 and 78982 constraints), at which the plain MSM of a key of 2^17 + 1
points and of each commit takes tens of minutes on the CPU; so there the
Nova case makes its commitments from the keys' discrete logs
(`dlog_commitments`) and holds the rest of the port's chain (synthesis,
cross term, folds, transcripts) to the decider. The `cuda` cases run every
cell on the card at small sizes (Nova at its own) with the port's MSMs.
"""

from __future__ import annotations

import contextlib
import time

import pytest
import torch

from kogarashi_tpu_torch.nova.pedersen import CURVES, PedersenCommitment

from zkbench import harness
from zkbench.drivers.common import patched
from zkbench.reference import nova as ref
from zkbench.reference.ec import G1, GRUMPKIN

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
SEED = 2**31 + 12345  # larger than 32 signed bits hold

CPU_CASES = {
    "g16-2p20-msm": ({"constraints_log2": 8, "scalar_pool": 2, "warmup": 1}, ["control", "altered", "half"]),
    "g16-2p20-prove": ({"constraints_log2": 3, "warmup": 0}, ["control", "altered", "half"]),
    "nova-example-fold": ({"warmup": 2}, ["control", "altered", "unchanged"]),
}
CARD_SIZES = {
    "g16-2p20-msm": {"constraints_log2": 12, "scalar_pool": 2, "warmup": 1},
    "g16-2p20-prove": {"constraints_log2": 10, "warmup": 1},
    "nova-example-fold": {"warmup": 2},
}


@contextlib.contextmanager
def dlog_commitments():
    """Pedersen keys kept as the discrete logs of their points, drawn from
    the key stream as the port draws them, and each commit made from them."""
    dlogs = {}

    def init(ck, curve_spec, k, rng, active=None, device=None):
        ck.spec = curve_spec
        ck.curve, order = CURVES[curve_spec.name]
        ck.key_len = (1 << k) + 1
        ck.n_active = min(active, ck.key_len) if active is not None else ck.key_len
        dlogs[curve_spec.name] = [rng.field_random(order) for _ in range(ck.key_len)]

    def commit(ck, msg):
        pt = ref.commit(G1 if ck.spec.name == "G1" else GRUMPKIN, dlogs[ck.spec.name], list(msg))
        if pt is None:
            return ck.spec.identity_affine()
        F = ck.spec.field
        return type(ck.spec.generator)(ck.spec, F(pt[0]), F(pt[1]), False)

    with patched(PedersenCommitment, "__init__", init), patched(PedersenCommitment, "commit", commit):
        yield


def one_run(cell, overrides, device, mode=None, seed=SEED):
    """A run of one request (the window closes after the first)."""
    on_cpu = cell == "nova-example-fold" and device == "cpu"
    with dlog_commitments() if on_cpu else contextlib.nullcontext():
        return harness.run_cell(BENCH, cell, seed, 1e-3, False, device, time.perf_counter(),
                                mode=mode, overrides=dict(overrides), log=lambda _: None)


@pytest.fixture
def cpu_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", list(CPU_CASES))
def test_sound_run_is_correct(cell, cpu_threads):
    res, checks = one_run(cell, CPU_CASES[cell][0], "cpu")
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1, checks
    assert all(v == 0 for _, v, _ in checks)
    assert {"setup_s"} < set(res["metrics"])


@pytest.mark.parametrize("cell,mode", [(c, m) for c, (_, modes) in CPU_CASES.items() for m in modes])
def test_control_and_faults_are_not_correct(cell, mode, cpu_threads):
    res, checks = one_run(cell, CPU_CASES[cell][0], "cpu", mode=mode)
    assert not res["correct"], (mode, checks)
    assert any(v > limit for _, v, limit in checks)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(CARD_SIZES))
def test_card_sound_control_and_faults(cell, card):
    sizes = CARD_SIZES[cell]
    res, checks = one_run(cell, sizes, card)
    assert res["correct"] and res["device"]["platform"] == "gpu", checks
    for mode in CPU_CASES[cell][1]:
        res, checks = one_run(cell, sizes, card, mode=mode)
        assert not res["correct"], (mode, checks)
