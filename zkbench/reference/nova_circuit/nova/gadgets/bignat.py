"""Non-native big-integer arithmetic in-circuit (bellman-bignat style).

The port's own copy of `kogarashi_tpu/nova/gadgets/bignat.py`.

Parity: nova/src/gadget/big_nat.rs — 4x64-bit limbs, witness allocation with
bit-binding, limb-polynomial multiplication checked at points 1..n, grouped
carry propagation with range checks (`enforce_equal_when_carried_regroup`),
`mult_mod` / `red_mod` via witnessed quotient+remainder.

Carry-bit counts replicate the reference's f64 log2 computation exactly
(big_nat.rs:224: `ceil(log2(2*max_word) - limb_width) + 0.1` in IEEE double).
"""

from __future__ import annotations

import math

from ...r1cs.gadgets.field import FieldAssignment as FA
from ...r1cs.gadgets.binary import BinaryAssignment

BN_LIMB_WIDTH = 64
BN_N_LIMBS = 4


def f_to_nat(v: int) -> int:
    return int(v)


def nat_to_f(n: int, p: int) -> int:
    """BigInt (< 2^512) -> field via wide reduction (big_nat.rs:17)."""
    return n % p


def nat_to_limbs(nat: int, limb_width: int, n_limbs: int) -> list[int]:
    assert nat.bit_length() <= n_limbs * limb_width, "Wrong amount of bits"
    mask = (1 << limb_width) - 1
    return [(nat >> (limb_width * i)) & mask for i in range(n_limbs)]


def limbs_to_nat(limbs: list[int], limb_width: int) -> int:
    acc = 0
    for limb in reversed(limbs):
        acc = (acc << limb_width) + limb
    return acc


class BigNatParams:
    __slots__ = ("min_bits", "max_word", "limb_width", "n_limbs")

    def __init__(self, limb_width: int, n_limbs: int):
        self.min_bits = 0
        self.max_word = (1 << limb_width) - 1
        self.limb_width = limb_width
        self.n_limbs = n_limbs


def _carry_bits(max_word: int, limb_width: int) -> int:
    """Reference's f64 computation, reproduced bit-for-bit in IEEE double."""
    return int(math.ceil(math.log2(float(max_word) * 2.0) - float(limb_width)) + 0.1)


class BigNatAssignment:
    __slots__ = ("limbs", "params")

    def __init__(self, limbs, params):
        self.limbs = limbs
        self.params = params

    # -- allocation --------------------------------------------------------
    @classmethod
    def witness_from_big_int(cls, cs, num: int, limb_width: int, n_limbs: int):
        vals = nat_to_limbs(num, limb_width, n_limbs)
        limbs = [FA.witness(cs, v) for v in vals]
        return cls(limbs, BigNatParams(limb_width, n_limbs))

    @classmethod
    def witness_from_field_assignment(cls, cs, f, limb_width: int, n_limbs: int):
        bn = cls.witness_from_big_int(cs, f.value(cs), limb_width, n_limbs)
        bv = bn.decompose(cs)
        FA.enforce_eq_bits(cs, f, bv)
        return bn

    @classmethod
    def from_poly(cls, poly: "Polynomial", limb_width: int, max_word: int):
        params = BigNatParams(limb_width, len(poly.coefficients))
        params.max_word = max_word
        return cls(list(poly.coefficients), params)

    # -- queries -----------------------------------------------------------
    def value(self, cs) -> int:
        return limbs_to_nat([l.value(cs) for l in self.limbs], self.params.limb_width)

    def as_limbs(self):
        return list(self.limbs)

    def n_bits(self) -> int:
        # NB: reference uses the global consts here, not params (big_nat.rs:447)
        return BN_LIMB_WIDTH * (BN_N_LIMBS - 1) + self.params.max_word.bit_length()

    # -- constraints -------------------------------------------------------
    def enforce_well_formed(self, cs):
        for limb in self.limbs:
            bits = FA.to_bits(cs, limb, 256)
            FA.range_check_bits(cs, bits, self.params.limb_width)

    def decompose(self, cs) -> list[BinaryAssignment]:
        """BE bit-vector over all limbs (MSB limb first)."""
        bits = []
        for limb in reversed(self.limbs):
            bits.extend(FA.to_bits(cs, limb, self.params.limb_width))
        return bits

    @classmethod
    def enforce_eq(cls, cs, x, y):
        assert len(x.limbs) == len(y.limbs)
        for a, b in zip(x.limbs, y.limbs):
            FA.enforce_eq(cs, a, b)

    @classmethod
    def conditional_select(cls, cs, a, b, condition):
        assert len(a.limbs) == len(b.limbs)
        limbs = [
            FA.conditional_select(cs, x, y, condition)
            for x, y in zip(a.limbs, b.limbs)
        ]
        return cls(limbs, a.params)

    def enforce_equal_when_carried_regroup(self, cs, other):
        assert self.params.limb_width == other.params.limb_width
        max_word = max(self.params.max_word, other.params.max_word)
        carry_bits = _carry_bits(max_word, self.params.limb_width)
        limbs_per_group = (cs.driver.num_bits - 1 - carry_bits) // self.params.limb_width
        sg = self.group_limbs(cs, limbs_per_group)
        og = other.group_limbs(cs, limbs_per_group)
        sg.enforce_equal_when_carried(cs, og)

    def enforce_equal_when_carried(self, cs, other):
        """big_nat.rs:224-289 — carry-chain equality with witnessed carries."""
        assert self.params.limb_width == other.params.limb_width
        p = cs.p
        n = min(len(self.limbs), len(other.limbs))
        target_base = 1 << self.params.limb_width
        accumulated_extra = 0
        max_word = max(self.params.max_word, other.params.max_word)
        carry_bits = _carry_bits(max_word, self.params.limb_width)
        carry_in = FA.constant(cs, 0)

        for i in range(n):
            carry_val = (
                self.limbs[i].value(cs)
                + carry_in.value(cs)
                + max_word
                - other.limbs[i].value(cs)
            ) // target_base
            carry = FA.witness(cs, nat_to_f(carry_val, p))
            accumulated_extra += max_word

            target_base_ass = FA.witness(cs, nat_to_f(target_base, p))
            target = FA.mul(cs, target_base_ass, carry)
            carry_sum = (carry_in + self.limbs[i]) - other.limbs[i]
            accumulated = FA.witness(cs, nat_to_f(accumulated_extra % target_base, p))
            max_word_ass = FA.witness(cs, nat_to_f(max_word, p))

            FA.enforce_eq_constant(
                cs, ((carry_sum + max_word_ass) - target) - accumulated, 0
            )

            accumulated_extra //= target_base
            if i < n - 1:
                carry_decomp = FA.to_bits(cs, carry, 256)
                FA.range_check_bits(cs, carry_decomp, carry_bits)
            else:
                acc_extra_ass = FA.witness(cs, nat_to_f(accumulated_extra, p))
                FA.enforce_eq_constant(cs, carry - acc_extra_ass, 0)
            carry_in = carry

        for limb in self.limbs[n:]:
            FA.enforce_eq_constant(cs, limb, 0)
        for limb in other.limbs[n:]:
            FA.enforce_eq_constant(cs, limb, 0)

    # -- arithmetic --------------------------------------------------------
    def add(self, other: "BigNatAssignment") -> "BigNatAssignment":
        assert self.params.limb_width == other.params.limb_width
        n_limbs = max(self.params.n_limbs, other.params.n_limbs)
        limbs = []
        for i in range(n_limbs):
            a = self.limbs[i] if i < len(self.limbs) else None
            b = other.limbs[i] if i < len(other.limbs) else None
            limbs.append(a + b if a and b else (a or b))
        params = BigNatParams(self.params.limb_width, n_limbs)
        params.max_word = self.params.max_word + other.params.max_word
        params.min_bits = max(self.params.min_bits, other.params.min_bits)
        return BigNatAssignment(limbs, params)

    def mult_mod(self, cs, other, modulus) -> "BigNatAssignment":
        """self * other mod modulus via witnessed q, r and limb-poly check."""
        assert self.params.limb_width == other.params.limb_width
        limb_width = self.params.limb_width
        quotient_bits = max(self.n_bits() + other.n_bits() - modulus.params.min_bits, 0)
        quotient_limbs = max(quotient_bits - 1, 0) // limb_width + 1
        sv, ov, mv = self.value(cs), other.value(cs), modulus.value(cs)
        quotient = BigNatAssignment.witness_from_big_int(
            cs, sv * ov // mv, limb_width, quotient_limbs
        )
        quotient.enforce_well_formed(cs)
        remainder = BigNatAssignment.witness_from_big_int(
            cs, sv * ov % mv, limb_width, len(modulus.limbs)
        )
        remainder.enforce_well_formed(cs)

        left = Polynomial.from_bignat(self).mul(cs, Polynomial.from_bignat(other))
        right = (
            Polynomial.from_bignat(quotient)
            .mul(cs, Polynomial.from_bignat(modulus))
            .add(Polynomial.from_bignat(remainder))
        )

        left_max_word = (
            min(len(self.limbs), len(other.limbs))
            * self.params.max_word
            * other.params.max_word
        )
        right_max_word = (
            min(len(quotient.limbs), len(modulus.limbs))
            * quotient.params.max_word
            * modulus.params.max_word
            + remainder.params.max_word
        )
        left_int = BigNatAssignment.from_poly(left, limb_width, left_max_word)
        right_int = BigNatAssignment.from_poly(right, limb_width, right_max_word)
        left_int.enforce_equal_when_carried_regroup(cs, right_int)
        return remainder

    def red_mod(self, cs, modulus) -> "BigNatAssignment":
        """self mod modulus (big_nat.rs:371)."""
        assert self.params.limb_width == modulus.params.limb_width
        limb_width = self.params.limb_width
        quotient_bits = max(self.n_bits() - modulus.params.min_bits, 0)
        quotient_limbs = max(quotient_bits - 1, 0) // limb_width + 1
        sv, mv = self.value(cs), modulus.value(cs)
        quotient = BigNatAssignment.witness_from_big_int(
            cs, sv // mv, limb_width, quotient_limbs
        )
        quotient.enforce_well_formed(cs)
        remainder = BigNatAssignment.witness_from_big_int(
            cs, sv % mv, limb_width, len(modulus.limbs)
        )
        remainder.enforce_well_formed(cs)

        right = (
            Polynomial.from_bignat(quotient)
            .mul(cs, Polynomial.from_bignat(modulus))
            .add(Polynomial.from_bignat(remainder))
        )
        right_max_word = (
            min(len(quotient.limbs), len(modulus.limbs))
            * quotient.params.max_word
            * modulus.params.max_word
            + remainder.params.max_word
        )
        right_int = BigNatAssignment.from_poly(right, limb_width, right_max_word)
        self.enforce_equal_when_carried_regroup(cs, right_int)
        return remainder

    def group_limbs(self, cs, limbs_per_group: int) -> "BigNatAssignment":
        n_groups = (len(self.limbs) - 1) // limbs_per_group + 1
        limbs = [FA.constant(cs, 0) for _ in range(n_groups)]
        shift = FA.constant(cs, 1)
        limb_block = FA.witness(cs, pow(2, self.params.limb_width, cs.p))
        for i, limb in enumerate(self.limbs):
            if i % limbs_per_group == 0:
                shift = FA.constant(cs, 1)
            limbs[i // limbs_per_group] = limbs[i // limbs_per_group] + FA.mul(
                cs, shift, limb
            )
            shift = FA.mul(cs, shift, limb_block)

        acc = 0
        for i in range(limbs_per_group):
            acc |= 1 << (i * self.params.limb_width)
        params = BigNatParams(
            self.params.limb_width * limbs_per_group, len(limbs)
        )
        params.max_word = acc * self.params.max_word
        params.min_bits = self.params.min_bits
        return BigNatAssignment(limbs, params)


class Polynomial:
    __slots__ = ("coefficients",)

    def __init__(self, coefficients):
        self.coefficients = coefficients

    @classmethod
    def from_bignat(cls, bn: BigNatAssignment) -> "Polynomial":
        return cls(list(bn.limbs))

    def mul(self, cs, other: "Polynomial") -> "Polynomial":
        """Limb convolution + evaluation checks at x = 1..n (big_nat.rs:455)."""
        p = cs.p
        n_product = len(self.coefficients) + len(other.coefficients) - 1
        product = [FA.constant(cs, 0) for _ in range(n_product)]
        for i, a in enumerate(self.coefficients):
            for j, b in enumerate(other.coefficients):
                product[i + j] = product[i + j] + FA.mul(cs, a, b)

        x = 0
        for _ in range(n_product):
            x = (x + 1) % p

            def eval_at(coeffs):
                acc = FA.constant(cs, 0)
                i_pow = 1
                for c in coeffs:
                    acc = acc + FA.mul(cs, c, FA.constant(cs, i_pow))
                    i_pow = i_pow * x % p
                return acc

            a = eval_at(self.coefficients)
            b = eval_at(other.coefficients)
            c = eval_at(product)
            ab = FA.mul(cs, a, b)
            FA.enforce_eq(cs, ab, c)
        return Polynomial(product)

    def add(self, other: "Polynomial") -> "Polynomial":
        n = max(len(self.coefficients), len(other.coefficients))
        out = []
        for i in range(n):
            terms = []
            if i < len(self.coefficients):
                terms.append(self.coefficients[i])
            if i < len(other.coefficients):
                terms.append(other.coefficients[i])
            acc = terms[0]
            for t in terms[1:]:
                acc = acc + t
            out.append(acc)
        return Polynomial(out)
