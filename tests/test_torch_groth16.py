"""The port's slice on the CPU: setup -> prove -> verify (plain versions of
the kernels), `benches.groth16_large.run` on a small square chain, and a
whole-slice comparison with the JAX package."""

import dataclasses
import random

import pytest
import torch

from kogarashi_tpu.r1cs.vector import SquareChainCircuit as JSquareChainCircuit
from kogarashi_tpu_torch.benches import groth16_large
from kogarashi_tpu_torch.errors import InconsistentPublicInputsLen
from kogarashi_tpu_torch.groth16 import Circuit, setup
from kogarashi_tpu_torch.r1cs import FieldAssignment

torch.set_num_threads(2)  # the suite runs several workers side by side

GROTH16_KEYS = {"metric", "constraints", "setup_s", "prove_s", "verify_s", "verified", "tamper_rejected",
                "backend"}  # benches/groth16_large.py:67-76


class CubicCircuit(Circuit):
    """x^3 + x + 5 = o (groth16/examples/simple.rs; tests/test_groth16.py)."""

    def __init__(self, x=0, o=0):
        self.x_val, self.o_val = x, o

    def synthesize(self, cs):
        x = FieldAssignment.instance(cs, self.x_val)
        o = FieldAssignment.instance(cs, self.o_val)
        c5 = FieldAssignment.constant(cs, 5)
        sym1 = FieldAssignment.mul(cs, x, x)
        y = FieldAssignment.mul(cs, sym1, x)
        sym2 = FieldAssignment.add(cs, y, x)
        FieldAssignment.enforce_eq(cs, sym2 + c5, o)


def test_cubic_prove_verify():
    prover, verifier = setup(CubicCircuit(), random.Random(42), device="cpu")
    proof = prover.create_proof(CubicCircuit(x=3, o=35), random.Random(7))
    assert verifier.verify(proof, [3, 35])
    assert not verifier.verify(proof, [3, 36])
    assert not verifier.verify(proof, [4, 35])
    with pytest.raises(InconsistentPublicInputsLen):
        verifier.verify(proof, [3, 35, 1])


@pytest.fixture(scope="module")
def square_chain():
    """SquareChainCircuit(2^2) set up and proved once, through
    groth16_large.run on the CPU: a CPU set-up and proof take tens of
    seconds whatever the circuit's size, so the tests below share this one
    and change only copies of it."""
    return groth16_large.run(2, "cpu")


def test_square_chain_prove_verify(square_chain):
    """The square chain's proof verifies; a changed public output, and a
    changed A (on a copy of the shared proof), are rejected."""
    _, (proof, inputs, verifier) = square_chain
    assert verifier.verify(proof, inputs)
    assert not verifier.verify(proof, [inputs[0], inputs[1] + 1])
    tampered = dataclasses.replace(proof, a=proof.a + proof.a.spec.generator)
    assert not verifier.verify(tampered, inputs)


def test_groth16_large_run(square_chain):
    """SquareChainCircuit(2^2) through groth16_large.run on the CPU: the
    record's keys and values; the proof verifies and a changed last public
    input is rejected; the public inputs are the JAX package's circuit's."""
    record, (proof, inputs, verifier) = square_chain
    assert set(record) == GROTH16_KEYS
    assert record["metric"] == "groth16_prove_2^2_constraints" and record["constraints"] == 4
    assert record["verified"] is True and record["tamper_rejected"] is True and record["backend"] == "cpu"
    assert inputs == JSquareChainCircuit(4).build().x[1:]
    assert verifier.verify(proof, inputs)


@pytest.mark.slow
def test_slice_matches_jax_bit_for_bit():
    """JAX setup(Random(11)) -> interop.params_from_jax -> port prover with
    Random(12) gives the JAX prover's Proof exactly; the port's own
    setup(Random(11)) gives the same verifying key and query points."""
    from kogarashi_tpu.groth16 import setup as jax_setup
    from kogarashi_tpu_torch import interop
    from kogarashi_tpu_torch.curves import G1, G2, decode_affine
    from kogarashi_tpu_torch.groth16 import Prover

    from test_torch_ec import coords

    circuit, witness = CubicCircuit(), CubicCircuit(x=3, o=35)
    jprover, jverifier = jax_setup(circuit, random.Random(11))
    port_params = interop.params_from_jax(jprover.params, device="cpu")

    jproof = jprover.create_proof(witness, random.Random(12))
    proof = Prover(port_params).create_proof(witness, random.Random(12))
    assert coords([proof.a, proof.b, proof.c]) == coords([jproof.a, jproof.b, jproof.c])
    assert jverifier.verify(jproof, [3, 35])

    own_prover, own_verifier = setup(circuit, random.Random(11), device="cpu")
    own = own_prover.params
    assert own.vk == port_params.vk
    for name, curve in (("h", G1), ("l", G1), ("a", G1), ("b_g1", G1), ("b_g2", G2)):
        assert decode_affine(curve, *getattr(own, name)) == decode_affine(curve, *getattr(port_params, name)), name
    assert own_verifier.verify(proof, [3, 35])
