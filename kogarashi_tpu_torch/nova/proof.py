"""Recursive proof and its verification (parity: nova/src/proof.rs).

The port's own copy of `kogarashi_tpu/nova/proof.py`; the satisfiability
checks run on the device of the public parameters' shapes.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..r1cs.driver import scalar_as_base
from .relaxed_r1cs import (
    R1csInstance,
    R1csWitness,
    RelaxedR1csInstance,
    RelaxedR1csWitness,
)


@dataclass
class RecursiveProof:
    i: int
    z0_primary: list
    z0_secondary: list
    zi_primary: list
    zi_secondary: list
    u_single_secondary: R1csInstance
    w_single_secondary: R1csWitness
    u_range_primary: RelaxedR1csInstance
    w_range_primary: RelaxedR1csWitness
    u_range_secondary: RelaxedR1csInstance
    w_range_secondary: RelaxedR1csWitness

    def verify(self, pp) -> bool:
        """Length checks, two state-hash checks, and three satisfiability
        checks (proof.rs:44-81)."""
        if (
            len(self.u_single_secondary.x) != 2
            or len(self.u_range_primary.x) != 2
            or len(self.u_range_secondary.x) != 2
        ):
            return False

        hash_primary = self.u_range_secondary.hash(
            self.i, self.z0_primary, self.zi_primary
        )
        hash_secondary = self.u_range_primary.hash(
            self.i, self.z0_secondary, self.zi_secondary
        )

        e2 = self.u_range_secondary.driver
        if hash_primary != self.u_single_secondary.x[0]:
            return False
        if hash_secondary != scalar_as_base(e2, self.u_single_secondary.x[1]):
            return False

        return (
            pp.shape_primary.is_sat_relaxed(self.u_range_primary, self.w_range_primary)
            and pp.shape_secondary.is_sat_relaxed(
                self.u_range_secondary, self.w_range_secondary
            )
            and pp.shape_secondary.is_sat(
                pp.ck_secondary, self.u_single_secondary, self.w_single_secondary
            )
        )
