"""IVC driver: the two-curve ping-pong (parity: nova/src/ivc.rs).

Counterpart of `kogarashi_tpu/nova/ivc.py`. `PublicParams.setup` takes
`device=None` (the card): the shapes' products and the Pedersen keys live
there, and every commitment is an MSM on it (G1 for the primary circuit,
Grumpkin for the secondary). Synthesis, transcripts and folds stay on the
host.

PublicParams::setup synthesizes both augmented circuits to freeze shapes and
sample Pedersen keys; Ivc::init runs the step-0 circuits; Ivc::prove_step
folds the secondary, re-synthesizes the primary, folds the primary, and
re-synthesizes the secondary, emitting a RecursiveProof.

A step function declares its arity; setup freezes the shapes with zero
states of it. A step function with per-step advice (`MinRootFunction`) is
set up with a shape-only instance, and `Ivc(...)` and `prove_step` take each
step's own instances, as microsoft/Nova's `RecursiveSNARK::new` and
`prove_step` take the step's circuits: the circuits given to `Ivc` make
z_1, the first `prove_step` (i = 0) only emits that proof, and the
`prove_step` at i makes z_{i+1}. Without them, both use `pp`'s.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

from ..devices import resolve
from ..r1cs import BN254_DRIVER, GRUMPKIN_DRIVER, R1CS
from .augmented import AugmentedFCircuit
from .nifs import NifsProver
from .pedersen import PedersenCommitment
from .proof import RecursiveProof
from .relaxed_r1cs import (
    R1csShape,
    RelaxedR1csInstance,
    RelaxedR1csWitness,
    r1cs_instance_and_witness,
)


@dataclass
class PublicParams:
    shape_primary: R1csShape
    shape_secondary: R1csShape
    ck_primary: PedersenCommitment
    ck_secondary: PedersenCommitment
    fc_primary: object
    fc_secondary: object

    @classmethod
    def setup(cls, fc_primary, fc_secondary, rng: random.Random, device=None):
        """ivc.rs:272 — synthesize both augmented circuits on zero states of
        the step functions' arities, freeze shapes, sample
        2^ceil(log2 m)+1-point Pedersen keys, on `device` (None: the card)."""
        e1, e2 = BN254_DRIVER, GRUMPKIN_DRIVER
        device = resolve(device)

        cs1 = R1CS(e1)
        AugmentedFCircuit(other_driver=e2, fc=fc_primary, is_primary=True,
                          z_0=[0] * fc_primary.arity).generate(cs1)
        shape_primary = R1csShape.from_r1cs(cs1, device)

        cs2 = R1CS(e2)
        AugmentedFCircuit(other_driver=e1, fc=fc_secondary, is_primary=False,
                          z_0=[0] * fc_secondary.arity).generate(cs2)
        shape_secondary = R1csShape.from_r1cs(cs2, device)

        k1 = max((shape_primary.m - 1).bit_length(), 1)
        ck_primary = PedersenCommitment(
            e1.commit_curve, k1, rng,
            active=max(shape_primary.m, shape_primary.m_l_1()), device=device,
        )
        k2 = max((shape_secondary.m - 1).bit_length(), 1)
        ck_secondary = PedersenCommitment(
            e2.commit_curve, k2, rng,
            active=max(shape_secondary.m, shape_secondary.m_l_1()), device=device,
        )

        return cls(
            shape_primary=shape_primary,
            shape_secondary=shape_secondary,
            ck_primary=ck_primary,
            ck_secondary=ck_secondary,
            fc_primary=fc_primary,
            fc_secondary=fc_secondary,
        )


class Ivc:
    def __init__(self, pp: PublicParams, z0_primary: list, z0_secondary: list,
                 primary=None, secondary=None):
        """ivc.rs:51 init — run the two step-0 circuits (`primary` and
        `secondary`: step 0's step functions; None: pp's)."""
        e1, e2 = BN254_DRIVER, GRUMPKIN_DRIVER
        self.pp = pp
        self.i = 0
        self.z0_primary = list(z0_primary)
        self.z0_secondary = list(z0_secondary)

        cs_primary = R1CS(e1)
        circuit_primary = AugmentedFCircuit(
            other_driver=e2, fc=pp.fc_primary if primary is None else primary,
            is_primary=True, i=0, z_0=self.z0_primary,
        )
        zi_primary = circuit_primary.generate(cs_primary)

        u_single_primary, w_single_primary = r1cs_instance_and_witness(
            cs_primary, pp.shape_primary, pp.ck_primary
        )
        self.prover_primary = NifsProver(pp.shape_primary, pp.ck_primary)

        cs_secondary = R1CS(e2)
        circuit_secondary = AugmentedFCircuit(
            other_driver=e1, fc=pp.fc_secondary if secondary is None else secondary,
            is_primary=False, i=0, z_0=self.z0_secondary, u_single=u_single_primary,
        )
        zi_secondary = circuit_secondary.generate(cs_secondary)

        u_single_secondary, w_single_secondary = r1cs_instance_and_witness(
            cs_secondary, pp.shape_secondary, pp.ck_secondary
        )
        self.prover_secondary = NifsProver(pp.shape_secondary, pp.ck_secondary)

        self.zi_primary = [z.value(cs_primary) for z in zi_primary]
        self.zi_secondary = [z.value(cs_secondary) for z in zi_secondary]
        self.u_single_secondary = u_single_secondary
        self.w_single_secondary = w_single_secondary
        self.u_range_primary = RelaxedR1csInstance.from_r1cs_instance(
            e1, u_single_primary
        )
        self.w_range_primary = RelaxedR1csWitness.from_r1cs_witness(
            pp.shape_primary, w_single_primary
        )
        self.u_range_secondary = RelaxedR1csInstance.dummy(
            e2, pp.shape_secondary.l()
        )
        self.w_range_secondary = RelaxedR1csWitness.dummy(
            pp.shape_secondary.m_l_1(), pp.shape_secondary.m
        )

    @classmethod
    def resume(cls, pp: PublicParams, proof: RecursiveProof) -> "Ivc":
        """Checkpoint/resume: rebuild the chain state from a proof.

        A RecursiveProof carries (i, z0, z_i, running + single
        instances/witnesses), the reference's resumable Ivc tuple
        (nova/src/ivc.rs:15-42, SURVEY §5); with `utils.serde` a chain can
        go on from any serialized step. The next `prove_step` commits on
        `pp`'s device.
        """
        ivc = cls.__new__(cls)
        ivc.pp = pp
        ivc.i = proof.i
        ivc.z0_primary = list(proof.z0_primary)
        ivc.z0_secondary = list(proof.z0_secondary)
        ivc.zi_primary = list(proof.zi_primary)
        ivc.zi_secondary = list(proof.zi_secondary)
        ivc.prover_primary = NifsProver(pp.shape_primary, pp.ck_primary)
        ivc.prover_secondary = NifsProver(pp.shape_secondary, pp.ck_secondary)
        ivc.u_single_secondary = proof.u_single_secondary
        ivc.w_single_secondary = proof.w_single_secondary
        ivc.u_range_primary = proof.u_range_primary
        ivc.w_range_primary = proof.w_range_primary
        ivc.u_range_secondary = proof.u_range_secondary
        ivc.w_range_secondary = proof.w_range_secondary
        return ivc

    def _proof(self) -> RecursiveProof:
        return RecursiveProof(
            i=self.i,
            z0_primary=list(self.z0_primary),
            z0_secondary=list(self.z0_secondary),
            zi_primary=list(self.zi_primary),
            zi_secondary=list(self.zi_secondary),
            u_single_secondary=self.u_single_secondary,
            w_single_secondary=self.w_single_secondary,
            u_range_primary=self.u_range_primary,
            w_range_primary=self.w_range_primary,
            u_range_secondary=self.u_range_secondary,
            w_range_secondary=self.w_range_secondary,
        )

    def prove_step(self, primary=None, secondary=None) -> RecursiveProof:
        """ivc.rs:132 — one fold-and-extend step; `primary` and `secondary`
        are step i's step functions (None: pp's), unused at i = 0."""
        e1, e2 = BN254_DRIVER, GRUMPKIN_DRIVER
        pp = self.pp
        if self.i == 0:
            self.i = 1
            return self._proof()

        (
            u_range_next_secondary,
            w_range_next_secondary,
            commit_t_secondary,
        ) = self.prover_secondary.prove(
            self.u_range_secondary,
            self.w_range_secondary,
            self.u_single_secondary,
            self.w_single_secondary,
        )

        cs_primary = R1CS(e1)
        circuit_primary = AugmentedFCircuit(
            other_driver=e2, fc=pp.fc_primary if primary is None else primary,
            is_primary=True, i=self.i,
            z_0=self.z0_primary, z_i=self.zi_primary,
            u_single=self.u_single_secondary,
            u_range=self.u_range_secondary,
            commit_t=commit_t_secondary,
        )
        zi_primary = circuit_primary.generate(cs_primary)
        u_single_next_primary, w_single_next_primary = r1cs_instance_and_witness(
            cs_primary, pp.shape_primary, pp.ck_primary
        )

        (
            u_range_next_primary,
            w_range_next_primary,
            commit_t_primary,
        ) = self.prover_primary.prove(
            self.u_range_primary,
            self.w_range_primary,
            u_single_next_primary,
            w_single_next_primary,
        )

        cs_secondary = R1CS(e2)
        circuit_secondary = AugmentedFCircuit(
            other_driver=e1, fc=pp.fc_secondary if secondary is None else secondary,
            is_primary=False, i=self.i,
            z_0=self.z0_secondary, z_i=self.zi_secondary,
            u_single=u_single_next_primary,
            u_range=self.u_range_primary,
            commit_t=commit_t_primary,
        )
        zi_secondary = circuit_secondary.generate(cs_secondary)
        u_single_next_secondary, w_single_next_secondary = r1cs_instance_and_witness(
            cs_secondary, pp.shape_secondary, pp.ck_secondary
        )

        self.i += 1
        self.u_range_primary = u_range_next_primary
        self.w_range_primary = w_range_next_primary
        self.u_range_secondary = u_range_next_secondary
        self.w_range_secondary = w_range_next_secondary
        self.u_single_secondary = u_single_next_secondary
        self.w_single_secondary = w_single_next_secondary
        self.zi_primary = [z.value(cs_primary) for z in zi_primary]
        self.zi_secondary = [z.value(cs_secondary) for z in zi_secondary]

        return self._proof()
