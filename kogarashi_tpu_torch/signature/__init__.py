"""RedDSA signatures over twisted Edwards curves (Jubjub).

The reference defines the trait surface only — `SigUtils<L>` byte serde and
the `RedDSA` curve bundle (zkstd/src/traits/sign.rs:6-27) — with Jubjub as
the intended instantiation (zkstd/tests/jubjub.rs). This module provides a
complete, working scheme with those semantics:

  - rerandomizable Schnorr signatures (RedJubjub-style) over the prime-order
    subgroup, with 32-byte compressed points (`SigUtils<32>` parity) and
    64-byte signatures,
  - host-side sign (O(1), not a device workload),
  - batched verification on the card: all the scalar muls of a signature
    batch run as one Edwards scalar-mul kernel (csrc/edwards.cu E1), the
    combine as E2 / E3 launches.

The port's own copy of `kogarashi_tpu/signature`.

The challenge hash is Blake2b-512 with a domain-separating personal string,
reduced mod the subgroup order via 64-byte wide reduction — the same
Blake2b + wide-reduction discipline the reference uses for MiMC constant
derivation (nova/src/hash/helper.rs).
"""

from .reddsa import (
    RedDSA,
    hash_to_scalar,
    SecretKey,
    Signature,
    VerificationKey,
    batch_verify,
)

__all__ = ["hash_to_scalar", "RedDSA", "SecretKey", "Signature", "VerificationKey", "batch_verify"]
