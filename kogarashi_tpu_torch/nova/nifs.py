"""NIFS folding scheme: prover computes the cross term and folds;
verifier recomputes the challenge and folds instances only.

Counterpart of `kogarashi_tpu/nova/nifs.py` (parity: nova/src/prover.rs
(Prover, compute_cross_term), verifier.rs). The cross term runs on the
device (`R1csShape.cross_term`), its commitment on the port's MSM.
"""

from __future__ import annotations

from .. import constants as C
from ..errors import MalformedProof
from ..pyref import MimcRO
from .pedersen import PedersenCommitment
from .relaxed_r1cs import (
    R1csInstance,
    R1csShape,
    R1csWitness,
    RelaxedR1csInstance,
    RelaxedR1csWitness,
)


def _transcript(driver) -> MimcRO:
    return MimcRO(driver.base, driver.scalar)


class NifsProver:
    def __init__(self, shape: R1csShape, ck: PedersenCommitment):
        self.shape = shape
        self.ck = ck

    def prove(
        self,
        instance1: RelaxedR1csInstance,
        witness1: RelaxedR1csWitness,
        instance2: R1csInstance,
        witness2: R1csWitness,
    ):
        if len(instance1.x) != len(instance2.x):
            raise MalformedProof(
                f"instance x-length mismatch: {len(instance1.x)} vs "
                f"{len(instance2.x)} (proof.rs:44-52 shape checks)"
            )
        if len(witness1.w) != len(witness2.w):
            raise MalformedProof(
                f"witness length mismatch: {len(witness1.w)} vs {len(witness2.w)}"
            )
        driver = self.shape.driver
        transcript = _transcript(driver)
        t = self.compute_cross_term(instance1, witness1, instance2, witness2)
        commit_t = self.ck.commit(t)
        transcript.append_point(commit_t)
        instance1.absorb_by_transcript(transcript)
        r = transcript.squeeze(C.CHALLENGE_BITS).v
        instance = instance1.fold(instance2, r, commit_t)
        witness = witness1.fold(witness2, r, t, self.shape.p)
        return instance, witness, commit_t

    def compute_cross_term(self, instance1, witness1, instance2, witness2) -> list:
        """T = AZ1 o BZ2 + AZ2 o BZ1 - u1 CZ2 - u2 CZ1 (prover.rs:53-90)."""
        return self.shape.cross_term(instance1, witness1, instance2, witness2)


class NifsVerifier:
    @staticmethod
    def verify(commit_t, instance1: RelaxedR1csInstance, instance2: R1csInstance):
        """Recompute r from the transcript and fold instances (verifier.rs:12)."""
        driver = instance1.driver
        transcript = _transcript(driver)
        transcript.append_point(commit_t)
        instance1.absorb_by_transcript(transcript)
        r = transcript.squeeze(C.CHALLENGE_BITS).v
        return instance1.fold(instance2, r, commit_t)
