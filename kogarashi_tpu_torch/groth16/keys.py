"""Proving/verifying keys and proofs.

Mirrors `kogarashi_tpu/groth16/keys.py` (:25-92), whose module cannot be
imported without JAX (its package `__init__` imports the JAX prover). The
verifying-key points are host pyref points; query vectors are affine word
batches (x, y, inf) on the prover's device, the MSM's input format.
Verification is the same three-pair check, on the port's copy of
`pyref.pairing_fast`; `Proof.pairs` gives the pairs to `ops.pairing`, which
evaluates them on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from ..errors import InconsistentPublicInputsLen
from ..pyref import AffinePoint, Fq12
from ..pyref.pairing_fast import G2Prepared, final_exp_fast, multi_miller_loop


@dataclass
class VerifyingKey:
    alpha_g1: AffinePoint
    beta_g1: AffinePoint
    beta_g2: AffinePoint
    gamma_g2: AffinePoint
    delta_g1: AffinePoint
    delta_g2: AffinePoint
    ic: list  # AffinePoints, len l

    def prepare(self) -> "PreparedVerifyingKey":
        return PreparedVerifyingKey(
            alpha_g1_beta_g2=final_exp_fast(
                multi_miller_loop([(self.alpha_g1, G2Prepared.from_affine(self.beta_g2))])
            ),
            neg_gamma_g2=G2Prepared.from_affine(-self.gamma_g2),
            neg_delta_g2=G2Prepared.from_affine(-self.delta_g2),
            ic=list(self.ic),
        )


@dataclass
class PreparedVerifyingKey:
    alpha_g1_beta_g2: Fq12
    neg_gamma_g2: G2Prepared
    neg_delta_g2: G2Prepared
    ic: list


@dataclass
class Parameters:
    vk: VerifyingKey
    h: Any  # G1 affine batch (x, y, inf), len n-1
    l: Any  # G1, len m_l_1
    a: Any  # G1, len l + m_l_1
    b_g1: Any  # G1
    b_g2: Any  # G2
    l_pub: int  # number of public wires
    n: int  # FFT domain size
    mats: Any  # COO dicts (A, B, C) on the device
    num_wires: int


@dataclass
class Proof:
    a: AffinePoint
    b: AffinePoint  # G2
    c: AffinePoint

    def pairs(self, pvk: PreparedVerifyingKey, public_inputs: list[int]) -> list:
        """The verify equation's three (G1, G2Prepared) pairs: (A, B),
        (acc, -gamma), (C, -delta), acc = ic_0 + sum x_i ic_i."""
        if len(public_inputs) + 1 != len(pvk.ic):
            raise InconsistentPublicInputsLen(len(pvk.ic) - 1, len(public_inputs))
        acc = pvk.ic[0]
        for x, b in zip(public_inputs, pvk.ic[1:]):
            acc = acc + x * b
        return [
            (self.a, G2Prepared.from_affine(self.b)),
            (acc, pvk.neg_gamma_g2),
            (self.c, pvk.neg_delta_g2),
        ]

    def verify(self, pvk: PreparedVerifyingKey, public_inputs: list[int]) -> bool:
        """e(A,B) e(acc,-gamma) e(C,-delta) == e(alpha,beta) (proof.rs:14-50),
        on the host. `ops.pairing` evaluates the same pairs on the card."""
        return final_exp_fast(multi_miller_loop(self.pairs(pvk, public_inputs))) == pvk.alpha_g1_beta_g2


class Verifier:
    """Parity: groth16/src/verifier.rs:14."""

    def __init__(self, vk: PreparedVerifyingKey):
        self.vk = vk

    def verify(self, proof: Proof, public_inputs: list[int]) -> bool:
        return proof.verify(self.vk, public_inputs)
