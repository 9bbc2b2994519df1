"""In-circuit NIFS fold verification (parity: nova/src/circuit/nifs.rs).

The port's own copy of `kogarashi_tpu/nova/gadgets/nifs.py`.
"""

from __future__ import annotations

from ...r1cs.gadgets.field import FieldAssignment as FA
from .bignat import BN_LIMB_WIDTH, BN_N_LIMBS, BigNatAssignment
from .instance import R1csInstanceAssignment, RelaxedR1csInstanceAssignment


class NifsCircuit:
    @staticmethod
    def verify(
        cs,
        other_driver,
        r: FA,
        u_range: RelaxedR1csInstanceAssignment,
        u_single: R1csInstanceAssignment,
        commit_t,
    ) -> RelaxedR1csInstanceAssignment:
        # W_fold = U.W + r * u.W
        r_w = u_single.commit_w.scalar_point(cs, r)
        w_fold = u_range.commit_w.add(cs, r_w)

        # E_fold = U.E + r * T
        r_t = commit_t.scalar_point(cs, r)
        e_fold = u_range.commit_e.add(cs, r_t)

        # non-native modulus: the folded instances' field (other driver's
        # ORDER_STR — nifs.rs:36)
        m_bn = int(other_driver.order_str, 16)
        r_bn_ass = BigNatAssignment.witness_from_field_assignment(
            cs, r, BN_LIMB_WIDTH, BN_N_LIMBS
        )
        m_bn_ass = BigNatAssignment.witness_from_big_int(
            cs, m_bn, BN_LIMB_WIDTH, BN_N_LIMBS
        )

        # u_fold = U.u + r
        u_fold = FA.witness(cs, (u_range.u.value(cs) + r.value(cs)) % cs.p)
        FA.enforce_eq_constant(cs, (u_fold - u_range.u) - r, 0)

        # x folds over the non-native modulus
        x0_single_bn = BigNatAssignment.witness_from_big_int(
            cs, u_single.x0.value(cs), BN_LIMB_WIDTH, BN_N_LIMBS
        )
        r_x0 = x0_single_bn.mult_mod(cs, r_bn_ass, m_bn_ass)
        x0_fold = u_range.x0.add(r_x0).red_mod(cs, m_bn_ass)

        x1_single_bn = BigNatAssignment.witness_from_big_int(
            cs, u_single.x1.value(cs), BN_LIMB_WIDTH, BN_N_LIMBS
        )
        r_x1 = x1_single_bn.mult_mod(cs, r_bn_ass, m_bn_ass)
        x1_fold = u_range.x1.add(r_x1).red_mod(cs, m_bn_ass)

        return RelaxedR1csInstanceAssignment(
            commit_w=w_fold,
            commit_e=e_fold,
            u=u_fold,
            x0=x0_fold,
            x1=x1_fold,
        )
