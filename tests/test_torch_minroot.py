"""The port's MinRoot step function (`nova.function.MinRootFunction`) and
step circuits with arity and per-step advice in its IVC, on the CPU, at 2^4
rounds a step: the step's R1CS, its counter and stage mark, its matrices
against the plain reference (`zkbench/reference/minroot.py`), a wrong hint,
the arity-2 augmented circuit at set-up against step 1, step 1 synthesized
witness-only (`WitnessCS`) against the full synthesis and the frozen rows,
and a two-step chain through `PublicParams`, `Ivc` and `prove_step` with
each step's advice, its constraints counted by the kind of system (its
folds' cross terms take most of the file's time)."""

import logging
import random

import pytest
import torch

from kogarashi_tpu_torch.nova import (
    COUNTS,
    Ivc,
    MinRootFunction,
    PublicParams,
    TrivialFunction,
    reset_counts,
)
from kogarashi_tpu_torch.nova.augmented import AugmentedFCircuit
from kogarashi_tpu_torch.nova.function import count_synthesis, synthesize
from kogarashi_tpu_torch.nova.pedersen import CURVES, PedersenCommitment
from kogarashi_tpu_torch.nova.relaxed_r1cs import R1csInstance, R1csShape, RelaxedR1csInstance
from kogarashi_tpu_torch.r1cs import BN254_DRIVER, GRUMPKIN_DRIVER, R1CS, FieldAssignment, WitnessCS
from zkbench.reference import minroot as ref
from zkbench.reference.nova_circuit import r1cs as ref_r1cs

torch.set_num_threads(2)  # the suite runs several workers side by side

R = BN254_DRIVER.scalar.p
ITERS = 16


def _chain(seed, steps=1, iters=ITERS):
    """(z_0, hints per step) of a chain made backward from a seeded end."""
    rng = random.Random(seed)
    return ref.chain_backward((rng.randrange(R), rng.randrange(R)), iters, steps)


def _step(fc, z, driver=BN254_DRIVER):
    """The port's step function alone in an R1CS, on witnesses z."""
    cs = R1CS(driver)
    out = synthesize(fc, cs, [FieldAssignment.witness(cs, v) for v in z], "primary")
    return cs, [v.value(cs) for v in out]


def test_step_is_satisfied_counted_and_marked(caplog):
    """3 constraints and 3 witness entries a round, z_next as the forward
    map gives it, COUNTS as synthesized and the INFO stage mark."""
    z0, (hints,) = _chain(1)
    fc = MinRootFunction(ITERS, hints)
    reset_counts()
    with caplog.at_level(logging.INFO, logger="kogarashi_tpu_torch.nova.function"):
        cs, z_next = _step(fc, z0)
    assert cs.m == 3 * ITERS and cs.m_l_1() == 2 + 3 * ITERS and cs.is_sat()
    assert COUNTS == {"steps": 1, "constraints": 3 * ITERS, "advice": ITERS,
                      "constraints_witness_only": 0, "constraints_with_rows": 0}
    assert tuple(z_next) == ref.forward(z0, ITERS) == tuple(fc.invoke(list(z0), R))
    assert fc.fifth_roots(list(z0), ITERS, R) == hints
    assert [r.args[:2] for r in caplog.records] == [("nova", "primary step synthesis")]
    reset_counts()
    assert set(COUNTS.values()) == {0}


def test_step_matrices_match_the_reference():
    """Row by row, the port's step circuit is the reference's (minroot.rs)."""
    z0, (hints,) = _chain(2)
    cs, z = _step(MinRootFunction(ITERS, hints), z0)
    rcs = ref_r1cs.R1CS(ref_r1cs.BN254_DRIVER)
    rz = [v.value(rcs) for v in ref.MinRootStep(ITERS, hints).invoke_cs(
        rcs, [ref_r1cs.FieldAssignment.witness(rcs, v) for v in z0])]
    assert (cs.m, cs.l(), cs.m_l_1(), cs.x, cs.w, z) == (rcs.m, rcs.l(), rcs.m_l_1(), rcs.x, rcs.w, rz)
    for (r, c, v), (rr, rc, rv) in zip(cs.matrices_coo(), rcs.matrices_coo()):
        assert r.tolist() == rr.tolist() and c.tolist() == rc.tolist() and v == rv


@pytest.mark.parametrize("k", [0, ITERS // 2, ITERS - 1])
def test_a_wrong_hint_leaves_the_step_unsatisfied(k):
    z0, (hints,) = _chain(3)
    hints[k] = (hints[k] + 1) % R
    cs, _ = _step(MinRootFunction(ITERS, hints), z0)
    assert not cs.is_sat()


def test_trivial_step_keeps_its_state():
    cs, z = _step(TrivialFunction, [7], driver=GRUMPKIN_DRIVER)
    assert (cs.m, z) == (0, [7]) and TrivialFunction.invoke([7], 5) == [2]
    with pytest.raises(ValueError):
        MinRootFunction(ITERS, [1, 2])


def _point(driver, rng):
    return driver.commit_curve.generator * rng.randrange(1, 1 << 250)


def _circuit(setup):
    """The arity-2 augmented circuit as PublicParams.setup synthesizes it
    (shape-only step, zero state), or else step 1 of a chain with its
    advice and real instances: u_range of random points and x values, and
    u_single's x0 the hash of (1, z_0, z_1, u_range) that the circuit checks."""
    other, rng = GRUMPKIN_DRIVER, random.Random(4)
    if setup:
        return AugmentedFCircuit(other_driver=other, fc=MinRootFunction(ITERS), is_primary=True, z_0=[0, 0])
    z0, hints = _chain(5, steps=2)
    z1 = list(ref.forward(z0, ITERS))
    u_range = RelaxedR1csInstance(driver=other, commit_w=_point(other, rng), commit_e=_point(other, rng),
                                  u=rng.randrange(other.scalar.p), x=[rng.randrange(1 << 250) for _ in range(2)])
    u_single = R1csInstance(commit_w=_point(other, rng), x=[u_range.hash(1, list(z0), z1), rng.randrange(1 << 250)])
    return AugmentedFCircuit(other_driver=other, fc=MinRootFunction(ITERS, hints[1]), is_primary=True, i=1,
                             z_0=list(z0), z_i=z1, u_single=u_single, u_range=u_range, commit_t=_point(other, rng))


_FULL = {}


def _full(setup):
    """_circuit(setup) synthesized into an R1CS, (cs, z_next values), once
    per module."""
    if setup not in _FULL:
        cs = R1CS(BN254_DRIVER)
        _FULL[setup] = cs, [v.value(cs) for v in _circuit(setup).generate(cs)]
    return _FULL[setup]


def test_setup_shape_is_step_ones():
    """The arity-2 augmented circuit as PublicParams.setup synthesizes it
    (shape-only step, zero state) has step 1's m, l and matrices."""
    (setup, _), (step1, _) = _full(True), _full(False)
    assert (setup.m, setup.l(), setup.m_l_1()) == (step1.m, step1.l(), step1.m_l_1())
    for (r, c, v), (r1, c1, v1) in zip(setup.matrices_coo(), step1.matrices_coo()):
        assert r.tolist() == r1.tolist() and c.tolist() == c1.tolist() and v == v1


def test_witness_only_step_matches_full_and_the_frozen_shape():
    """Step 1 synthesized into a WitnessCS, as prove_step does: the R1CS's
    m, l, m_l_1, x, w and z_next element for element, counted as
    witness-only, and A z o B z = C z on the rows set-up freezes."""
    step1, z = _full(False)
    reset_counts()
    ws = WitnessCS(BN254_DRIVER)
    wz = [v.value(ws) for v in _circuit(False).generate(ws)]
    assert (COUNTS["constraints_witness_only"], COUNTS["constraints_with_rows"]) == (ws.m, 0)
    assert (ws.m, ws.l(), ws.m_l_1(), ws.x, ws.w, wz) == (step1.m, step1.l(), step1.m_l_1(), step1.x, step1.w, z)
    assert tuple(wz) == ref.forward(_chain(5, steps=2)[0], 2 * ITERS)
    shape = R1csShape.from_r1cs(_full(True)[0], "cpu")
    assert (shape.m, shape.l() + 1, shape.m_l_1()) == (ws.m, ws.l(), ws.m_l_1())
    rows = zip(shape.a, shape.b, shape.c)
    assert all(a.evaluate(ws.x, ws.w) * b.evaluate(ws.x, ws.w) % shape.p == c.evaluate(ws.x, ws.w) for a, b, c in rows)


def test_a_witness_cs_freezes_no_shape_and_counts_apart():
    """R1csShape.from_r1cs refuses a WitnessCS (it keeps no rows); each kind
    of system moves its own count, and reset_counts clears both."""
    with pytest.raises(TypeError):
        R1csShape.from_r1cs(WitnessCS(BN254_DRIVER), "cpu")
    reset_counts()
    count_synthesis(WitnessCS(GRUMPKIN_DRIVER), 3)
    count_synthesis(R1CS(GRUMPKIN_DRIVER), 5)
    assert (COUNTS["constraints_witness_only"], COUNTS["constraints_with_rows"]) == (3, 5)
    reset_counts()
    assert set(COUNTS.values()) == {0}


@pytest.fixture
def dlog_keys(monkeypatch):
    """Pedersen keys kept as their points' discrete logs: the plain MSM of
    a 2^17 + 1-point key takes too long on the CPU."""
    def init(ck, curve_spec, k, rng, active=None, device=None):
        ck.spec = curve_spec
        ck.curve, ck.order = CURVES[curve_spec.name]
        ck.key_len = (1 << k) + 1
        ck.n_active = min(active, ck.key_len) if active is not None else ck.key_len
        ck.dlogs = [rng.randrange(1, ck.order) for _ in range(ck.key_len)]

    def commit(ck, msg):
        return ck.spec.generator * (sum(a * b for a, b in zip(msg, ck.dlogs)) % ck.order)

    monkeypatch.setattr(PedersenCommitment, "__init__", init)
    monkeypatch.setattr(PedersenCommitment, "commit", commit)


def test_chain_takes_each_steps_advice(dlog_keys):
    """MinRoot through PublicParams, Ivc and prove_step (a fold on each
    curve): the proof verifies and z_i is the forward map's. Set-up
    synthesizes with rows, `Ivc` and every prove_step past the base case
    witness-only (both circuits' m each)."""
    iters = 4
    reset_counts()
    pp = PublicParams.setup(MinRootFunction(iters), TrivialFunction, random.Random(6), device="cpu")
    assert (pp.shape_primary.m, pp.shape_secondary.m) == (77680, 78980)
    m = pp.shape_primary.m + pp.shape_secondary.m
    assert (COUNTS["constraints_with_rows"], COUNTS["constraints_witness_only"]) == (m, 0)
    z0, hints = _chain(7, steps=2, iters=iters)
    ivc = Ivc(pp, list(z0), [11], primary=MinRootFunction(iters, hints[0]))
    for _ in range(2):
        proof = ivc.prove_step(primary=MinRootFunction(iters, hints[ivc.i]))
    assert (COUNTS["constraints_with_rows"], COUNTS["constraints_witness_only"]) == (m, 2 * m)
    assert proof.i == 2 and tuple(proof.zi_primary) == ref.forward(z0, 2 * iters)
    assert proof.zi_secondary == [11] and proof.verify(pp)
