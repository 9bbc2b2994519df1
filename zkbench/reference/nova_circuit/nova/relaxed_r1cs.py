"""Instances of the R1CS and relaxed R1CS relations, as the augmented circuit
and the decider read them: field values are ints, commitments pyref affine
points. The instance half of the port's `nova/relaxed_r1cs.py` (parity:
nova/src/relaxed_r1cs/instance.rs); the shape and its products are the
decider's own (`reference/nova.py`).
"""

from __future__ import annotations

from dataclasses import dataclass

from .. import constants as C
from ..pyref import MimcRO


@dataclass
class R1csInstance:
    commit_w: object  # AffinePoint
    x: list  # ints, len l

    @classmethod
    def dummy(cls, driver, x_len: int) -> "R1csInstance":
        return cls(commit_w=driver.commit_curve.identity_affine(), x=[0] * x_len)


@dataclass
class RelaxedR1csInstance:
    driver: object
    commit_w: object
    commit_e: object
    u: int
    x: list

    @classmethod
    def dummy(cls, driver, x_len: int) -> "RelaxedR1csInstance":
        ident = driver.commit_curve.identity_affine()
        return cls(driver=driver, commit_w=ident, commit_e=ident, u=0, x=[0] * x_len)

    def absorb_by_transcript(self, transcript: MimcRO):
        """instance.rs:103 — points, u (as base), x as 4x64-bit limbs (as base)."""
        base = self.driver.base
        transcript.append_point(self.commit_w)
        transcript.append_point(self.commit_e)
        transcript.append(base(self.u % base.p))
        for x in self.x:
            for limb_i in range(C.BN_N_LIMBS):
                limb = (x >> (C.BN_LIMB_WIDTH * limb_i)) & ((1 << C.BN_LIMB_WIDTH) - 1)
                transcript.append(base(limb))

    def hash(self, i: int, z0: list, zi: list) -> int:
        """hash(i, z0, zi, self) squeezed to HASH_BITS (instance.rs:118)."""
        base, scalar = self.driver.base, self.driver.scalar
        ro = MimcRO(base, scalar)
        ro.append(base(i))
        ro.append_vec([base(v) for v in z0])
        ro.append_vec([base(v) for v in zi])
        self.absorb_by_transcript(ro)
        return ro.squeeze(C.HASH_BITS).v
