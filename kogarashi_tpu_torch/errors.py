"""The failure modes the port raises (parity: groth16/src/error.rs,
nova/src/proof.rs).

The port's own copy of `kogarashi_tpu/errors.py`.
"""

from __future__ import annotations


class KogarashiError(Exception):
    """Base class for all protocol-level failures."""


class ProverSubVersionCrsAttack(KogarashiError):
    """CRS contains an identity delta/gamma: a subverted setup
    (error.rs: ProverSubVersionCrsAttack)."""


class ProverInversionFailed(KogarashiError):
    """A field inversion of zero inside proving
    (error.rs: ProverInversionFailed)."""


class ProofVerificationError(KogarashiError):
    """Pairing/hash equation mismatch (error.rs: ProofVerificationError)."""


class InconsistentPublicInputsLen(KogarashiError):
    """Public input vector length differs from the verifying key
    (error.rs: InconsistentPublicInputsLen)."""

    def __init__(self, expected: int, provided: int):
        super().__init__(f"expected {expected} public inputs, got {provided}")
        self.expected = expected
        self.provided = provided


class MalformedProof(KogarashiError):
    """Structural defect in a decoded proof: wrong x-vector lengths
    (nova/src/proof.rs:44-52), off-curve or out-of-subgroup points,
    non-canonical field bytes."""


class DecodeError(KogarashiError):
    """SCALE decoding failed: truncated input or invalid encoding."""
