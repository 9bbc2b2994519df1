"""Pure-Python bigint oracle: BN254 fields, the Fq2/Fq6/Fq12 tower, G1, G2
and Grumpkin, Jubjub over BLS12-381's scalar field, the transparent affine
pairing (`pairing`) and the coefficient-based one the verifier runs
(`pairing_fast`), the target group (`gt.Gt`), Nova's MiMC transcript, and
(in `subgroup`, not exported here) the torsion checks the proof decoders run.

The port's own copy of the parts of `kogarashi_tpu/pyref` it uses. Slow,
obvious Python, used as a test oracle and for O(1) host-side glue (verifying
keys, proof assembly, verification), never on the hot path.
"""

from .field import Fq, Fr, PrimeField
from .tower import Fq2, Fq6, Fq12
from .curve import (
    AffinePoint,
    CurveSpec,
    G1_SPEC,
    G2_SPEC,
    GRUMPKIN_SPEC,
    ProjectivePoint,
    batch_to_affine,
)
from .pairing import pairing, miller_loop, final_exp, untwist
from .edwards import BlsScalar, EdwardsAffine, EdwardsExtended, EdwardsSpec, JUBJUB_SPEC
from .mimc import Mimc, MimcRO, mimc_constants

__all__ = [
    "Fq",
    "Fr",
    "PrimeField",
    "Fq2",
    "Fq6",
    "Fq12",
    "AffinePoint",
    "ProjectivePoint",
    "CurveSpec",
    "G1_SPEC",
    "G2_SPEC",
    "GRUMPKIN_SPEC",
    "batch_to_affine",
    "pairing",
    "miller_loop",
    "final_exp",
    "untwist",
    "BlsScalar",
    "EdwardsAffine",
    "EdwardsExtended",
    "EdwardsSpec",
    "JUBJUB_SPEC",
    "Mimc",
    "MimcRO",
    "mimc_constants",
]
