"""The port's runnable entry points (`kogarashi_tpu_torch.bench`, `.entry`,
`.benches.*`) held to the repo's JAX-side scripts (`bench.py`,
`__graft_entry__.py`, `benches/*.py`) on the CPU, at small sizes: the same
seeds give the same inputs, oracles and public inputs, and each prints its
original's JSON keys. The real Nova chain (one step takes minutes on the CPU)
runs only on the card, in chip_smoke.py's nova phase; here `ivc_chain.run`
drives a stub chain."""

import json
import random
from pathlib import Path

import numpy as np
import pytest
import torch

from kogarashi_tpu import constants as JC
from kogarashi_tpu.curves import G1 as JG1
from kogarashi_tpu.fields import FQ_OPS, FR_OPS
from kogarashi_tpu.fields.spec import N_LIMBS
from kogarashi_tpu.nova.function import ExampleFunction as JExampleFunction
from kogarashi_tpu.r1cs.vector import SquareChainCircuit as JSquareChainCircuit
from kogarashi_tpu_torch import bench, entry
from kogarashi_tpu_torch.benches import groth16_large, ivc_chain, microbench
from kogarashi_tpu_torch.curves import G1, decode_points

torch.set_num_threads(2)  # the suite runs several workers side by side

ROOT = Path(__file__).resolve().parent.parent

BENCH_KEYS = {"metric", "value", "unit", "vs_baseline"}  # bench.py:98-103
GROTH16_KEYS = {"metric", "constraints", "setup_s", "prove_s", "verify_s", "verified", "tamper_rejected",
                "backend"}  # benches/groth16_large.py:67-76
IVC_KEYS = {"metric", "steps", "setup_s", "chain_s", "steps_per_s", "steady_step_s", "final_verified",
            "tamper_rejected", "backend"}  # benches/ivc_chain.py:69-79


def _ints(pt):
    """A pyref affine point of either package -> (x, y) ints (None: the identity)."""
    return None if pt.is_infinity else (pt.x.v, pt.y.v)


def test_bench_workload_is_bench_py():
    """bench.py's formulas (:55-78) with the JAX package's r and pyref give
    the port's bases, scalar limbs and oracle at n = 2^8."""
    log_n, n, nd = 8, 256, 64
    x, y, inf, scalars, expected = bench.workload(log_n, "cpu")
    rng = random.Random(0xBE7C4)
    dk = [rng.randrange(1, JC.R) for _ in range(nd)]
    g = JG1.pyref_spec.generator
    want = [_ints(k * g) for k in dk]
    xs, ys = (G1.decode_coords(t.numpy()) for t in (x, y))
    assert [(a.v, b.v) for a, b in zip(xs, ys)] == [want[i % nd] for i in range(n)]
    assert not inf.any()
    sc = np.random.default_rng(1).integers(0, 1 << 16, size=(N_LIMBS, n), dtype=np.uint32)
    sc[N_LIMBS - 1] &= 0x3FFF
    assert np.array_equal(scalars.numpy().astype(np.int64), sc.astype(np.int64))
    limb_w = [1 << (16 * limb) for limb in range(N_LIMBS)]
    eff = [0] * nd
    for i in range(n):
        eff[i % nd] += sum(int(sc[limb, i]) * limb_w[limb] for limb in range(N_LIMBS))
    assert _ints(expected) == _ints(sum((e % JC.R) * k for e, k in zip(eff, dk)) % JC.R * g)


def test_bench_main_env_overrides(monkeypatch, capsys):
    """KOGARASHI_BENCH_LOG_N / _C / _REPS are honoured; the MSM is held to the
    oracle on every call; stdout is one JSON line with bench.py's keys."""
    for k, v in (("LOG_N", "8"), ("C", "8"), ("REPS", "1")):
        monkeypatch.setenv(f"KOGARASHI_BENCH_{k}", v)
    assert bench.main(["--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    lines = out.splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert set(rec) == BENCH_KEYS
    assert rec["metric"] == "bn254_g1_msm_point_adds_per_s_2^8"
    assert rec["unit"] == "point-adds/s/chip"
    assert rec["value"] > 0 and rec["vs_baseline"] == rec["value"] / 1e8
    assert err.startswith("# n=2^8 c=8 windows=32 ") and "oracle=PASS" in err and "device=cpu" in err
    assert err.count("times=[") == 1 and len(err.split("times=[")[1].split("]")[0].split(",")) == 1


def test_entry_is_graft_entry():
    """entry()'s inputs are __graft_entry__.entry()'s as integers, and its
    fn gives the pyref sum."""
    import __graft_entry__
    from kogarashi_tpu.ops.msm_pallas import curve_k

    fn, (x, y, inf, scalars) = entry.entry("cpu")
    _, (jx, jy, jinf, jscalars) = __graft_entry__.entry()
    K = curve_k(JG1).K
    rinv = pow(K.mont_r, -1, K.p)

    def ints13(rows):
        return [sum(int(v) << (13 * i) for i, v in enumerate(r)) * rinv % K.p for r in np.asarray(rows)]

    assert [v.v for v in G1.decode_coords(x.numpy())] == ints13(jx)
    assert [v.v for v in G1.decode_coords(y.numpy())] == ints13(jy)
    assert np.array_equal(inf.numpy(), np.asarray(jinf))
    assert np.array_equal(scalars.numpy().astype(np.int64), np.asarray(jscalars).astype(np.int64))
    rng = random.Random(7)
    dk = [rng.randrange(1, 2**64) for _ in range(16)]
    ks = [rng.randrange(2**254) for _ in range(128)]
    want = sum(k * dk[i % 16] for i, k in enumerate(ks)) % JC.R * JG1.pyref_spec.generator
    assert fn.keywords == {"c": 8}
    assert _ints(decode_points(G1, fn(x, y, inf, scalars))[0]) == _ints(want) == _ints(entry.oracle())
    assert entry.dryrun_multichip.__module__ == "kogarashi_tpu_torch.parallel.dryrun"


def test_groth16_large_run():
    """SquareChainCircuit(2^2) through groth16_large.run on the CPU: the
    proof verifies and a changed last public input is rejected; the public
    inputs are the JAX package's circuit's."""
    record, (proof, inputs, verifier) = groth16_large.run(2, "cpu")
    assert set(record) == GROTH16_KEYS
    assert record["metric"] == "groth16_prove_2^2_constraints" and record["constraints"] == 4
    assert record["verified"] is True and record["tamper_rejected"] is True and record["backend"] == "cpu"
    assert inputs == JSquareChainCircuit(4).build().x[1:]
    assert verifier.verify(proof, inputs)


def test_groth16_large_main_writes_only_out(monkeypatch, capsys, tmp_path):
    """main prints run's record as one JSON line and writes a file only
    to --out (never GROTH16_2POW*.json in the repo root)."""
    record = {k: 1 for k in GROTH16_KEYS}
    monkeypatch.setattr(groth16_large, "run", lambda device=None: (record, None))
    before = sorted(p.name for p in ROOT.iterdir())
    out = tmp_path / "g16.json"
    assert groth16_large.main(["--device", "cpu", "--out", str(out)]) == 0
    assert groth16_large.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [json.loads(s) for s in lines] == [record, record]
    assert json.loads(out.read_text()) == record
    assert sorted(p.name for p in ROOT.iterdir()) == before
    assert [p.name for p in tmp_path.iterdir()] == ["g16.json"]


class _StubProof:
    def __init__(self, i, z, strict):
        self.i, self.zi_primary, self.strict = i, z, strict

    def verify(self, pp):
        return not self.strict or self.zi_primary == ivc_chain.chain_state(self.i)


def _stub_chain(monkeypatch, strict=True):
    """Replace PublicParams and Ivc in ivc_chain with a chain that keeps
    ExampleFunction's state; `strict`: its proofs check z_i."""
    seen = {}

    class PP:
        @classmethod
        def setup(cls, fc1, fc2, rng, device=None):
            seen.update(fc=(fc1, fc2), draw=rng.random(), device=device)
            return cls()

    class StubIvc:
        def __init__(self, pp, z0_primary, z0_secondary):
            self.i, self.zi_primary = 0, list(z0_primary)

        def prove_step(self):
            self.i += 1
            self.zi_primary = [(z**3 + z + 5) % JC.R for z in self.zi_primary]
            return _StubProof(self.i, list(self.zi_primary), strict)

    monkeypatch.setattr(ivc_chain, "PublicParams", PP)
    monkeypatch.setattr(ivc_chain, "Ivc", StubIvc)
    return seen


def test_ivc_chain_state_oracle():
    """chain_state(i) is the JAX package's ExampleFunction.invoke i times from 0."""
    z = [0]
    for i in range(6):
        assert ivc_chain.chain_state(i) == z
        z = JExampleFunction.invoke(z, JC.R)


def test_ivc_chain_run_on_a_stub(monkeypatch):
    """ivc_chain.run's keys, seed, step count, state check and tamper check
    over a stub chain; `cap_s` cuts the chain after 5 steps; a proof that
    verifies whatever its z_i fails the tamper check."""
    seen = _stub_chain(monkeypatch)
    entered = []

    class Around:
        def __enter__(self):
            entered.append(True)

        def __exit__(self, *exc):
            return False

    record, detail = ivc_chain.run(7, "cpu", verify_every=2, around_steps=Around())
    assert set(record) == IVC_KEYS
    assert record["metric"] == "nova_ivc_chain" and record["steps"] == 7 and record["backend"] == "cpu"
    assert record["final_verified"] is True and record["tamper_rejected"] is True
    assert len(detail["step_s"]) == 7 and entered == [True]
    assert record["steady_step_s"] == pytest.approx(sum(detail["step_s"][2:]) / 5)
    assert seen["draw"] == random.Random(99).random() and seen["fc"][0] is ivc_chain.ExampleFunction
    assert ivc_chain.run(10, "cpu", cap_s=0.0)[0]["steps"] == 5
    _stub_chain(monkeypatch, strict=False)
    with pytest.raises(AssertionError, match="tampered proof verified"):
        ivc_chain.run(3, "cpu")


def test_ivc_chain_main_env_and_out(monkeypatch, capsys, tmp_path):
    _stub_chain(monkeypatch)
    monkeypatch.setenv("KOGARASHI_IVC_STEPS", "4")
    out = tmp_path / "ivc.json"
    assert ivc_chain.main(["--device", "cpu", "--out", str(out)]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["steps"] == 4 and json.loads(out.read_text()) == rec


@pytest.mark.parametrize("group", ["field", "ntt"])
def test_microbench_names(capsys, group):
    """--batch 256 --device cpu: one {"bench", "value", "unit"} line per op
    under benches/microbench.py's names, each checked on its first lanes
    before it is timed."""
    assert microbench.main(["--batch", "256", "--device", "cpu", "--only", group]) == 0
    recs = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert all(set(r) == {"bench", "value", "unit"} for r in recs)
    assert recs[0] == {"bench": "backend", "value": 0, "unit": "cpu"}
    if group == "field":
        want = [f"{f.spec.name}/{op}" for f in (FR_OPS, FQ_OPS) for op in ("add", "sub", "mul", "square", "invert")]
    else:
        want = ["ntt/fr_2^10"]  # k = max(10, min(16, log2 256)), benches/microbench.py:129
    assert [r["bench"] for r in recs[1:]] == want
    assert all(r["value"] > 0 for r in recs[1:])


@pytest.mark.parametrize("main", [bench.main, groth16_large.main, ivc_chain.main, microbench.main,
                                  lambda argv: entry.entry()], ids=["bench", "groth16_large", "ivc_chain",
                                                                     "microbench", "entry"])
def test_entry_points_need_the_card(monkeypatch, main):
    """Without --device cpu every entry point asks for the card, and raises
    where there is none, before it does any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([])
