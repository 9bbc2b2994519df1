"""The port's MinRoot step function (`nova.function.MinRootFunction`) and
step circuits with arity and per-step advice in its IVC, on the CPU, at 2^4
rounds a step: the step's R1CS, its counter and stage mark, its matrices
against the plain reference (`zkbench/reference/minroot.py`), a wrong hint,
the arity-2 augmented circuit at set-up against step 1, and a two-step chain
through `PublicParams`, `Ivc` and `prove_step` with each step's advice (its
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
from kogarashi_tpu_torch.nova.function import synthesize
from kogarashi_tpu_torch.nova.pedersen import CURVES, PedersenCommitment
from kogarashi_tpu_torch.nova.relaxed_r1cs import R1csInstance, RelaxedR1csInstance
from kogarashi_tpu_torch.r1cs import BN254_DRIVER, GRUMPKIN_DRIVER, R1CS, FieldAssignment
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
    assert COUNTS == {"steps": 1, "constraints": 3 * ITERS, "advice": ITERS}
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


def test_setup_shape_is_step_ones():
    """The arity-2 augmented circuit as PublicParams.setup synthesizes it
    (shape-only step, zero state) has step 1's m, l and matrices."""
    other, rng = GRUMPKIN_DRIVER, random.Random(4)
    setup = R1CS(BN254_DRIVER)
    AugmentedFCircuit(other_driver=other, fc=MinRootFunction(ITERS), is_primary=True,
                      z_0=[0, 0]).generate(setup)
    z0, hints = _chain(5, steps=2)
    z1 = list(ref.forward(z0, ITERS))
    step1 = R1CS(BN254_DRIVER)
    AugmentedFCircuit(
        other_driver=other, fc=MinRootFunction(ITERS, hints[1]), is_primary=True, i=1, z_0=list(z0), z_i=z1,
        u_single=R1csInstance(commit_w=_point(other, rng), x=[rng.randrange(1 << 250) for _ in range(2)]),
        u_range=RelaxedR1csInstance(driver=other, commit_w=_point(other, rng), commit_e=_point(other, rng),
                                    u=rng.randrange(other.scalar.p), x=[rng.randrange(1 << 250) for _ in range(2)]),
        commit_t=_point(other, rng),
    ).generate(step1)
    assert (setup.m, setup.l(), setup.m_l_1()) == (step1.m, step1.l(), step1.m_l_1())
    for (r, c, v), (r1, c1, v1) in zip(setup.matrices_coo(), step1.matrices_coo()):
        assert r.tolist() == r1.tolist() and c.tolist() == c1.tolist() and v == v1


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
    curve): the proof verifies and z_i is the forward map's."""
    iters = 4
    pp = PublicParams.setup(MinRootFunction(iters), TrivialFunction, random.Random(6), device="cpu")
    assert (pp.shape_primary.m, pp.shape_secondary.m) == (77680, 78980)
    z0, hints = _chain(7, steps=2, iters=iters)
    ivc = Ivc(pp, list(z0), [11], primary=MinRootFunction(iters, hints[0]))
    for _ in range(2):
        proof = ivc.prove_step(primary=MinRootFunction(iters, hints[ivc.i]))
    assert proof.i == 2 and tuple(proof.zi_primary) == ref.forward(z0, 2 * iters)
    assert proof.zi_secondary == [11] and proof.verify(pp)
