"""Nova's augmented step circuit F' (parity: nova/src/circuit/augmented.rs).

The port's own copy of `kogarashi_tpu/nova/augmented.py`.

Generated inside an R1CS or a WitnessCS over CS (the *companion* driver of C): allocates the
step inputs, checks `u_single.x0 == hash(i, z0, zi, u_range)` (except in the
base case), squeezes the folding challenge, verifies the NIFS fold in-circuit,
runs the user step function, and exposes (u_single.x1, hash of the next
state) as the two public inputs.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Optional

from .. import constants as CONST
from ..r1cs import FieldAssignment as FA, PointAssignment
from .function import count_synthesis, synthesize
from .gadgets.instance import R1csInstanceAssignment, RelaxedR1csInstanceAssignment
from .gadgets.mimc import MimcROCircuit
from .gadgets.nifs import NifsCircuit
from .relaxed_r1cs import R1csInstance, RelaxedR1csInstance


@dataclass
class AugmentedFCircuit:
    """C = the *other* driver (whose instances are folded in this circuit);
    fc = the step function over this circuit's scalar field: a FunctionCircuit
    class, or an instance carrying its step's advice; z_0 has its arity."""

    other_driver: object
    fc: object
    is_primary: bool = True
    i: int = 0
    z_0: list = dc_field(default_factory=lambda: [0])
    z_i: Optional[list] = None
    u_single: Optional[R1csInstance] = None
    u_range: Optional[RelaxedR1csInstance] = None
    commit_t: Optional[object] = None  # pyref AffinePoint

    def generate(self, cs) -> list:
        """Returns z_next FieldAssignments (augmented.rs:42-125); `cs` is an
        R1CS (rows and values) or a WitnessCS (values only)."""
        C = self.other_driver
        m = cs.m
        i = FA.witness(cs, self.i)
        z_0 = [FA.witness(cs, v) for v in self.z_0]
        z_i_vals = self.z_i if self.z_i is not None else list(self.z_0)
        z_i = [FA.witness(cs, v) for v in z_i_vals]

        u_dummy_native = RelaxedR1csInstance.dummy(C, 2)
        u_dummy = RelaxedR1csInstanceAssignment.witness(cs, C, u_dummy_native)
        u_single = R1csInstanceAssignment.witness(
            cs, C, self.u_single if self.u_single is not None else R1csInstance.dummy(C, 2)
        )
        u_range = RelaxedR1csInstanceAssignment.witness(
            cs, C, self.u_range if self.u_range is not None else u_dummy_native
        )

        ct = self.commit_t if self.commit_t is not None else C.commit_curve.identity_affine()
        commit_t = PointAssignment.witness(cs, ct.x.v, ct.y.v, ct.is_infinity)

        zero = FA.constant(cs, 0)
        base_case = FA.is_eq(cs, i, zero)
        not_base_case = FA.is_neq(cs, i, zero)

        # base-case candidate for the next running instance
        if self.is_primary:
            u_range_next_base = u_dummy
        else:
            u_range_next_base = RelaxedR1csInstanceAssignment.from_r1cs_instance(
                cs, u_single
            )

        u_i_x = u_range.hash(cs, i, z_0, z_i)
        FA.conditional_enforce_equal(cs, u_single.x0, u_i_x, not_base_case)

        r = self.get_challenge(cs, u_range, commit_t)
        u_range_next_non_base = NifsCircuit.verify(cs, C, r, u_range, u_single, commit_t)

        u_range_next = RelaxedR1csInstanceAssignment.conditional_select(
            cs, u_range_next_base, u_range_next_non_base, base_case
        )

        z_next = synthesize(self.fc, cs, z_i, "primary" if self.is_primary else "secondary")

        u_next_x = u_range_next.hash(
            cs, i + FA.constant(cs, 1), z_0, z_next
        )

        FA.inputize(cs, u_single.x1)
        FA.inputize(cs, u_next_x)
        count_synthesis(cs, cs.m - m)
        return z_next

    @staticmethod
    def get_challenge(cs, u_range, commit_t) -> FA:
        transcript = MimcROCircuit(cs.driver.scalar)
        transcript.append_point(commit_t)
        u_range.absorb_by_transcript(cs, transcript)
        return transcript.squeeze(cs, CONST.CHALLENGE_BITS)
