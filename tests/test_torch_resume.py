"""The port's `Ivc.resume` and its stricter satisfiability checks, on the
CPU. Resume: from the dummy proof of tests/test_torch_serde.py, decoded from
its bytes, the port and the JAX package rebuild the same chain state
(compared by ints), and `_proof()` encodes to the input bytes; marked slow,
the port's reference chain resumed from its 3-step bytes takes step 4 and
gives the JAX package's step-4 digest. The checks (port only; the JAX
package zips E with the products and so takes a short E): `is_sat_relaxed`
and `is_sat` reject a short or empty E and a short W, and `NovaPallet`
rejects a verifying proof re-encoded with `w_range_primary.e = []`."""

import hashlib
import random

import pytest
import torch

from kogarashi_tpu.nova import ExampleFunction as JExampleFunction, Ivc as JIvc, PublicParams as JPublicParams
from kogarashi_tpu.nova.pedersen import PedersenCommitment as JPedersen
from kogarashi_tpu.nova.relaxed_r1cs import R1csShape as JR1csShape
from kogarashi_tpu.r1cs import BN254_DRIVER as JBN, GRUMPKIN_DRIVER as JGR, R1CS as JR1CS
from kogarashi_tpu.r1cs import FieldAssignment as JFA
from kogarashi_tpu.utils import serde as jserde
from kogarashi_tpu_torch import interop
from kogarashi_tpu_torch.nova import (
    ExampleFunction,
    Ivc,
    PublicParams,
    R1csInstance,
    R1csWitness,
    RecursiveProof,
    RelaxedR1csInstance,
    RelaxedR1csWitness,
)
from kogarashi_tpu_torch.nova.pedersen import PedersenCommitment
from kogarashi_tpu_torch.nova.relaxed_r1cs import R1csShape, r1cs_instance_and_witness
from kogarashi_tpu_torch.pallet import NovaPallet
from kogarashi_tpu_torch.r1cs import BN254_DRIVER, GRUMPKIN_DRIVER, R1CS, FieldAssignment
from kogarashi_tpu_torch.utils import serde
from kogarashi_tpu_torch.utils.xorshift import REFERENCE_TEST_SEED, XorShiftRng
from test_torch_serde import _dummy_proof

torch.set_num_threads(2)  # the suite runs several workers side by side


def free_inputs_r1cs(FA, R1, driver, x, w):
    """Two public inputs x (free: no constraint reads them) and w^3 + w + 5
    on a private w, modulo the circuit's p."""
    cs = R1(driver)
    for v in x:
        FA.instance(cs, v)
    a = FA.witness(cs, w)
    b = FA.mul(cs, FA.mul(cs, a, a), a)
    FA.enforce_eq(cs, FA.add(cs, b, a) + FA.constant(cs, 5), FA.witness(cs, (w**3 + w + 5) % cs.p))
    return cs


def pt(q):
    """An affine point of either package -> ints."""
    return (True,) if q.is_infinity else (False, q.x.v, q.y.v)


def relaxed(u):
    return (pt(u.commit_w), pt(u.commit_e), u.u, list(u.x))


def state(ivc):
    """An Ivc's chain state as ints."""
    return (ivc.i, ivc.z0_primary, ivc.z0_secondary, ivc.zi_primary, ivc.zi_secondary,
            pt(ivc.u_single_secondary.commit_w), ivc.u_single_secondary.x, ivc.w_single_secondary.w,
            relaxed(ivc.u_range_primary), ivc.w_range_primary.w, ivc.w_range_primary.e,
            relaxed(ivc.u_range_secondary), ivc.w_range_secondary.w, ivc.w_range_secondary.e)


@pytest.fixture(scope="module")
def pps():
    """The JAX package's public parameters on small shapes (the free-input
    circuit over both drivers, keys sampled on the host) and the port's,
    carried over by `interop.public_params_from_jax`."""
    jshapes, jkeys = [], []
    for k, jdriver in enumerate((JBN, JGR)):
        shape = JR1csShape.from_r1cs(free_inputs_r1cs(JFA, JR1CS, jdriver, [1, 2], 3))
        ck = JPedersen(jdriver.commit_curve, max((shape.m - 1).bit_length(), 1), random.Random(21 + k))
        ck.commit = ck.commit_host
        jshapes.append(shape)
        jkeys.append(ck)
    jpp = JPublicParams(*jshapes, *jkeys, JExampleFunction, JExampleFunction)
    return jpp, interop.public_params_from_jax(jpp, device="cpu")


def test_resume_matches_jax(pps):
    """Both packages resume from the same bytes (the dummy proof, decoded
    by each) to the same state, with provers on the given keys, and the
    resumed chain's proof encodes to those bytes."""
    jpp, pp = pps
    data = serde.encode_recursive_proof(_dummy_proof(random.Random(0xC0FFEE), "port"))
    ivc = Ivc.resume(pp, serde.decode_recursive_proof(data))
    jivc = JIvc.resume(jpp, jserde.decode_recursive_proof(data))
    assert state(ivc) == state(jivc)
    assert ivc.prover_primary.ck is pp.ck_primary and ivc.prover_secondary.shape is pp.shape_secondary
    assert serde.encode_recursive_proof(ivc._proof()) == data
    assert jserde.encode_recursive_proof(jivc._proof()) == data


@pytest.fixture(scope="module")
def port_pp():
    """The port's public parameters on the free-input shapes, and a proof
    that verifies against them: relaxed instances made from satisfying
    circuits, and the secondary single instance's public inputs set to the
    two state hashes `RecursiveProof.verify` checks."""
    rng = random.Random(5)
    shapes, keys = [], []
    for driver in (BN254_DRIVER, GRUMPKIN_DRIVER):
        shape = R1csShape.from_r1cs(free_inputs_r1cs(FieldAssignment, R1CS, driver, [1, 2], 3), "cpu")
        shapes.append(shape)
        keys.append(PedersenCommitment(driver.commit_curve, max((shape.m - 1).bit_length(), 1), rng, device="cpu"))
    pp = PublicParams(*shapes, *keys, ExampleFunction, ExampleFunction)

    def instance(driver, shape, ck, x, w):
        return r1cs_instance_and_witness(free_inputs_r1cs(FieldAssignment, R1CS, driver, x, w), shape, ck)

    x1, w1 = instance(BN254_DRIVER, shapes[0], keys[0], [7, 8], 9)
    x2, w2 = instance(GRUMPKIN_DRIVER, shapes[1], keys[1], [10, 11], 12)
    u_primary = RelaxedR1csInstance.from_r1cs_instance(BN254_DRIVER, x1)
    u_secondary = RelaxedR1csInstance.from_r1cs_instance(GRUMPKIN_DRIVER, x2)
    i, z0, zi = 3, [0], [rng.randrange(1 << 250)]
    hashes = [u_secondary.hash(i, z0, zi), u_primary.hash(i, z0, zi)]
    xs, ws = instance(GRUMPKIN_DRIVER, shapes[1], keys[1], hashes, 13)
    proof = RecursiveProof(
        i=i, z0_primary=z0, z0_secondary=z0, zi_primary=zi, zi_secondary=zi,
        u_single_secondary=xs, w_single_secondary=ws,
        u_range_primary=u_primary, w_range_primary=RelaxedR1csWitness.from_r1cs_witness(shapes[0], w1),
        u_range_secondary=u_secondary, w_range_secondary=RelaxedR1csWitness.from_r1cs_witness(shapes[1], w2))
    assert proof.verify(pp)
    return pp, proof


def test_sat_checks_reject_short_vectors(port_pp):
    """A short or empty E and a short W fail `is_sat_relaxed`; a short W
    fails `is_sat` (the JAX package's zip would accept the first two)."""
    pp, proof = port_pp
    shape, u, w = pp.shape_primary, proof.u_range_primary, proof.w_range_primary
    assert shape.is_sat_relaxed(u, w)
    for e in ([], w.e[:-1]):
        assert not shape.is_sat_relaxed(u, RelaxedR1csWitness(w=w.w, e=e))
    assert not shape.is_sat_relaxed(u, RelaxedR1csWitness(w=w.w[:-1], e=w.e))
    ss, us, ws = pp.shape_secondary, proof.u_single_secondary, proof.w_single_secondary
    assert ss.is_sat(pp.ck_secondary, us, ws)
    assert not ss.is_sat(pp.ck_secondary, us, R1csWitness(w=ws.w[:-1]))
    assert not ss.is_sat(pp.ck_secondary, R1csInstance(commit_w=us.commit_w, x=us.x[:-1]), ws)


def test_pallet_rejects_empty_e(port_pp):
    """The proof's bytes verify through NovaPallet; re-encoded with
    w_range_primary.e = [] they decode and are rejected (InvalidProof)."""
    pp, proof = port_pp
    pallet = NovaPallet()
    assert pallet.verify("alice", serde.encode_recursive_proof(proof), pp)
    emptied = serde.decode_recursive_proof(serde.encode_recursive_proof(proof))
    emptied.w_range_primary = RelaxedR1csWitness(w=emptied.w_range_primary.w, e=[])
    data = serde.encode_recursive_proof(emptied)
    assert serde.decode_recursive_proof(data).w_range_primary.e == []
    assert not pallet.verify("mallory", data, pp)
    assert pallet.events == [("ProofVerified", "alice"), ("InvalidProof", "mallory")]


@pytest.mark.slow
def test_resumed_step_four_matches_jax():
    """The port's reference chain (the reference seed, on the CPU) encoded
    after 3 steps, decoded, resumed and stepped once: step 4's sha256 is the
    JAX package's uninterrupted step 4's. Every commit is a 77-79k-point
    plain MSM: the two chains take about 90 minutes on a CPU."""
    pp = PublicParams.setup(ExampleFunction, ExampleFunction,
                            XorShiftRng.from_seed(REFERENCE_TEST_SEED), device="cpu")
    ivc = Ivc(pp, z0_primary=[0], z0_secondary=[0])
    for _ in range(3):
        proof = ivc.prove_step()
    step4 = Ivc.resume(pp, serde.decode_recursive_proof(serde.encode_recursive_proof(proof))).prove_step()

    from kogarashi_tpu.utils.xorshift import XorShiftRng as JXorShiftRng

    jpp = JPublicParams.setup(JExampleFunction, JExampleFunction, JXorShiftRng.from_seed(REFERENCE_TEST_SEED))
    jivc = JIvc(jpp, z0_primary=[0], z0_secondary=[0])
    for _ in range(4):
        jproof = jivc.prove_step()
    assert step4.i == jproof.i == 4
    assert (hashlib.sha256(serde.encode_recursive_proof(step4)).hexdigest()
            == hashlib.sha256(jserde.encode_recursive_proof(jproof)).hexdigest())
