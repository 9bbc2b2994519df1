"""Instance gadgets for the augmented circuit.

The port's own copy of `kogarashi_tpu/nova/gadgets/instance.py`.

Parity: nova/src/gadget/instance.rs (R1csInstanceAssignment) and
relaxed_instance.rs (RelaxedR1csInstanceAssignment). These arithmetize
instances of the *other* curve's circuit: commitments become in-circuit
points (coordinates live in this circuit's scalar field), the other field's
public IO crosses over via bit-reinterpretation (x0/x1) or 4x64 BigNat limbs.
"""

from __future__ import annotations

from ... import constants as C
from ...r1cs.driver import scalar_as_base
from ...r1cs.gadgets.curve import PointAssignment
from ...r1cs.gadgets.field import FieldAssignment as FA
from .bignat import BN_LIMB_WIDTH, BN_N_LIMBS, BigNatAssignment
from .mimc import MimcROCircuit


class R1csInstanceAssignment:
    __slots__ = ("commit_w", "x0", "x1")

    def __init__(self, commit_w, x0, x1):
        self.commit_w = commit_w
        self.x0 = x0
        self.x1 = x1

    @classmethod
    def witness(cls, cs, other_driver, instance):
        """instance: nova R1csInstance of the other driver."""
        cw = instance.commit_w
        commit_w = PointAssignment.witness(cs, cw.x.v, cw.y.v, cw.is_infinity)
        x0 = FA.witness(cs, scalar_as_base(other_driver, instance.x[0]))
        x1 = FA.witness(cs, scalar_as_base(other_driver, instance.x[1]))
        return cls(commit_w, x0, x1)

    @classmethod
    def conditional_select(cls, cs, a, b, condition):
        return cls(
            PointAssignment.conditional_select(cs, a.commit_w, b.commit_w, condition),
            FA.conditional_select(cs, a.x0, b.x0, condition),
            FA.conditional_select(cs, a.x1, b.x1, condition),
        )


class RelaxedR1csInstanceAssignment:
    __slots__ = ("commit_w", "commit_e", "u", "x0", "x1")

    def __init__(self, commit_w, commit_e, u, x0, x1):
        self.commit_w = commit_w
        self.commit_e = commit_e
        self.u = u
        self.x0 = x0
        self.x1 = x1

    @classmethod
    def witness(cls, cs, other_driver, instance):
        def pt(q):
            return PointAssignment.witness(cs, q.x.v, q.y.v, q.is_infinity)

        commit_w = pt(instance.commit_w)
        commit_e = pt(instance.commit_e)
        u = FA.witness(cs, scalar_as_base(other_driver, instance.u))
        x0 = BigNatAssignment.witness_from_big_int(
            cs, instance.x[0], BN_LIMB_WIDTH, BN_N_LIMBS
        )
        x1 = BigNatAssignment.witness_from_big_int(
            cs, instance.x[1], BN_LIMB_WIDTH, BN_N_LIMBS
        )
        return cls(commit_w, commit_e, u, x0, x1)

    @classmethod
    def from_r1cs_instance(cls, cs, instance: R1csInstanceAssignment):
        """E = identity, u = 1 (relaxed_instance.rs:62)."""
        return cls(
            commit_w=instance.commit_w,
            commit_e=PointAssignment.identity(cs),
            u=FA.constant(cs, 1),
            x0=BigNatAssignment.witness_from_field_assignment(
                cs, instance.x0, BN_LIMB_WIDTH, BN_N_LIMBS
            ),
            x1=BigNatAssignment.witness_from_field_assignment(
                cs, instance.x1, BN_LIMB_WIDTH, BN_N_LIMBS
            ),
        )

    @classmethod
    def conditional_select(cls, cs, a, b, condition):
        return cls(
            PointAssignment.conditional_select(cs, a.commit_w, b.commit_w, condition),
            PointAssignment.conditional_select(cs, a.commit_e, b.commit_e, condition),
            FA.conditional_select(cs, a.u, b.u, condition),
            BigNatAssignment.conditional_select(cs, a.x0, b.x0, condition),
            BigNatAssignment.conditional_select(cs, a.x1, b.x1, condition),
        )

    def absorb_by_transcript(self, cs, transcript: MimcROCircuit):
        commit_e = self.commit_e.descale(cs)
        commit_w = self.commit_w.descale(cs)
        transcript.append_point(commit_w)
        transcript.append_point(commit_e)
        transcript.append(self.u)
        for limb in self.x0.as_limbs():
            transcript.append(limb)
        for limb in self.x1.as_limbs():
            transcript.append(limb)

    def hash(self, cs, i: FA, z_0: list, z_i: list) -> FA:
        ro = MimcROCircuit(cs.driver.scalar)
        ro.append(i)
        ro.append_vec(z_0)
        ro.append_vec(z_i)
        self.absorb_by_transcript(cs, ro)
        return ro.squeeze(cs, C.HASH_BITS)
