"""Chain-integration layer: the pallet-nova verifier dispatchable.

The port's own copy of `kogarashi_tpu/pallet`. Parity:
pallet/nova/src/lib.rs (Config, `verify` dispatchable, events), traits.rs
(IvcVerifier). The Substrate runtime itself is out of scope; this module
reproduces the pallet's observable behavior: a stateless `verify` entry
point over SCALE-encoded recursive proofs, event emission, and the `sample`
pallet's coupling pattern (sample/src/lib.rs:53-70: run a business
extrinsic only if the attached proof verifies). Proofs verify on the device
of the public parameters' shapes, the card unless the caller built them on
the CPU.
"""

from .nova_pallet import IvcVerifier, NovaPallet, SamplePallet

__all__ = ["IvcVerifier", "NovaPallet", "SamplePallet"]
