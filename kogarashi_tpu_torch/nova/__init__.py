"""Nova folding / IVC on the BN254 <-> Grumpkin cycle.

Counterpart of `kogarashi_tpu/nova`: synthesis, transcripts and folds on the
host as there; the shapes' products and every Pedersen commitment on the
device (`ops.spmv`, `ops.msm` on G1 and Grumpkin), the card by default.

Parity: nova/src/ — NIFS folding with Pedersen commitments and a MiMC
Fiat-Shamir transcript, the augmented step circuit with in-circuit fold
verification (EC scalar muls + BigNat non-native arithmetic), and the
two-curve IVC ping-pong emitting recursive proofs.
"""

from .function import ExampleFunction, FunctionCircuit
from .ivc import Ivc, PublicParams
from .nifs import NifsProver, NifsVerifier
from .pedersen import PedersenCommitment
from .proof import RecursiveProof
from .relaxed_r1cs import (
    R1csInstance,
    R1csShape,
    R1csWitness,
    RelaxedR1csInstance,
    RelaxedR1csWitness,
    r1cs_instance_and_witness,
)
from .augmented import AugmentedFCircuit

__all__ = [
    "ExampleFunction",
    "FunctionCircuit",
    "Ivc",
    "PublicParams",
    "NifsProver",
    "NifsVerifier",
    "PedersenCommitment",
    "RecursiveProof",
    "R1csInstance",
    "R1csShape",
    "R1csWitness",
    "RelaxedR1csInstance",
    "RelaxedR1csWitness",
    "r1cs_instance_and_witness",
    "AugmentedFCircuit",
]
