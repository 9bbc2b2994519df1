"""pallet-nova equivalent: on-chain IVC verification entry points.

The port's own copy of `kogarashi_tpu/pallet/nova_pallet.py`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..utils.serde import decode_recursive_proof


class IvcVerifier:
    """traits.rs:5: the verification hook the runtime calls."""

    @staticmethod
    def verify(proof, public_params) -> bool:
        return proof.verify(public_params)


@dataclass
class NovaPallet:
    """lib.rs:88-116: `verify(origin, proof, pp)` dispatchable + events."""

    events: list = field(default_factory=list)

    def verify(self, origin: str, proof, public_params) -> bool:
        """Dispatchable: accepts a RecursiveProof object or SCALE bytes,
        decoded on the host (`utils.serde`) and verified by the port's
        `RecursiveProof.verify`, on the device of `public_params`.

        Emits ("ProofVerified", origin) on success; returns the dispatch
        result (the reference returns DispatchResultWithPostInfo, error
        `InvalidProof` on failure).
        """
        if isinstance(proof, (bytes, bytearray)):
            proof = decode_recursive_proof(bytes(proof))
        ok = IvcVerifier.verify(proof, public_params)
        self.events.append(("ProofVerified" if ok else "InvalidProof", origin))
        return ok


@dataclass
class SamplePallet:
    """sample/src/lib.rs:53-70: business logic gated on proof verification."""

    nova: NovaPallet = field(default_factory=NovaPallet)
    thing: int = 0
    events: list = field(default_factory=list)

    def set_thing_1(self, origin: str, value: int, proof, public_params) -> bool:
        if not self.nova.verify(origin, proof, public_params):
            return False
        self.thing = value
        self.events.append(("ThingSet", origin, value))
        return True
