"""Nova folding / IVC on the BN254 <-> Grumpkin cycle.

Counterpart of `kogarashi_tpu/nova`: synthesis, transcripts and folds on the
host as there; the shapes' products and every Pedersen commitment on the
device (`ops.spmv`, `ops.msm` on G1 and Grumpkin), the card by default.

Parity: nova/src/ — NIFS folding with Pedersen commitments and a MiMC
Fiat-Shamir transcript, the augmented step circuit with in-circuit fold
verification (EC scalar muls + BigNat non-native arithmetic), and the
two-curve IVC ping-pong emitting recursive proofs.

`COUNTS` (`function.py`) counts step synthesis; `R1CS_COUNTS`
(`relaxed_r1cs.COUNTS`) counts the cross terms and where their field values
were converted.
"""

from .function import COUNTS, ExampleFunction, FunctionCircuit, MinRootFunction, TrivialFunction, reset_counts
from .ivc import Ivc, PublicParams
from .nifs import NifsProver, NifsVerifier
from .pedersen import PedersenCommitment
from .proof import RecursiveProof
from .relaxed_r1cs import (
    COUNTS as R1CS_COUNTS,
    R1csInstance,
    R1csShape,
    R1csWitness,
    RelaxedR1csInstance,
    RelaxedR1csWitness,
    r1cs_instance_and_witness,
    reset_counts as reset_r1cs_counts,
)
from .augmented import AugmentedFCircuit

__all__ = [
    "COUNTS",
    "ExampleFunction",
    "FunctionCircuit",
    "MinRootFunction",
    "TrivialFunction",
    "reset_counts",
    "R1CS_COUNTS",
    "reset_r1cs_counts",
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
