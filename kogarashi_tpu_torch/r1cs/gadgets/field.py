"""In-circuit field-element gadget (linear combination wrapper).

Parity: zkstd/src/circuit/gadget/field.rs — constant-folding mul/add, BE bit
decomposition with range check against a constant (bellman-style running
product), equality/selection gadgets with inverse-witness tricks.
"""

from __future__ import annotations

from .binary import BinaryAssignment


class FieldAssignment:
    """A linear combination of wires, of the system's kind (`cs.wire_lc`),
    and its value mod p, computed as it is built."""

    __slots__ = ("lc", "v")

    def __init__(self, lc, v: int):
        self.lc = lc
        self.v = v

    # -- allocation --------------------------------------------------------
    @classmethod
    def instance(cls, cs, value: int):
        wire = cs.public_wire()
        v = value % cs.p
        cs.x.append(v)
        return cls(cs.wire_lc(wire), v)

    @classmethod
    def witness(cls, cs, value: int):
        wire = cs.private_wire()
        v = value % cs.p
        cs.w.append(v)
        return cls(cs.wire_lc(wire), v)

    @classmethod
    def inputize(cls, cs, witness: "FieldAssignment"):
        wire = cs.public_wire()
        cs.x.append(witness.v)
        return cls(cs.wire_lc(wire), witness.v)

    @classmethod
    def constant(cls, cs, c: int):
        return cls(cs.const_lc(c), c % cs.p)

    @classmethod
    def from_binary_in(cls, cs, b: BinaryAssignment):
        return cls(cs.wire_lc(b.wire), cs.wire_value(b.wire))

    def value(self, cs) -> int:
        return self.v

    # -- arithmetic (constant-folding like the reference) ------------------
    @classmethod
    def mul(cls, cs, x: "FieldAssignment", y: "FieldAssignment"):
        cx = x.lc.as_constant()
        if cx is not None:
            return cls(y.lc.scale(cx), y.v * cx % cs.p)
        cy = y.lc.as_constant()
        if cy is not None:
            return cls(x.lc.scale(cy), x.v * cy % cs.p)
        z = cls.witness(cs, x.v * y.v)
        cs.mul_gate(x.lc, y.lc, z.lc)
        return z

    @classmethod
    def square(cls, cs, x):
        return cls.mul(cs, x, x)

    @classmethod
    def add(cls, cs, x: "FieldAssignment", y: "FieldAssignment"):
        cx = x.lc.as_constant()
        if cx is not None:
            return cls(y.lc + cs.const_lc(cx), (y.v + cx) % cs.p)
        cy = y.lc.as_constant()
        if cy is not None:
            return cls(x.lc + cs.const_lc(cy), (x.v + cy) % cs.p)
        z = cls.witness(cs, x.v + y.v)
        cs.add_gate(x.lc, y.lc, z.lc)
        return z

    def __add__(self, o):
        return FieldAssignment(self.lc + o.lc, (self.v + o.v) % self.lc.p)

    def __sub__(self, o):
        return FieldAssignment(self.lc - o.lc, (self.v - o.v) % self.lc.p)

    def __neg__(self):
        return FieldAssignment(-self.lc, -self.v % self.lc.p)

    # -- constraints -------------------------------------------------------
    @classmethod
    def enforce_eq(cls, cs, x, y):
        cs.mul_gate(x.lc, cs.one_lc(), y.lc)

    @classmethod
    def enforce_eq_constant(cls, cs, x, c: int):
        cs.mul_gate(x.lc, cs.one_lc(), cs.const_lc(c))

    @classmethod
    def conditional_enforce_equal(cls, cs, x, y, should_enforce: BinaryAssignment):
        diff = x - y
        m = cls.mul(cs, diff, cls.from_binary_in(cs, should_enforce))
        cls.enforce_eq_constant(cs, m, 0)

    @classmethod
    def conditional_select(cls, cs, a, b, condition: BinaryAssignment):
        """condition ? a : b."""
        cb = cls.from_binary_in(cs, condition)
        sel_a = cls.mul(cs, a, cb)
        one_minus = cls.constant(cs, 1) - cb
        sel_b = cls.mul(cs, b, one_minus)
        return sel_a + sel_b

    @classmethod
    def is_neq(cls, cs, x, y) -> BinaryAssignment:
        """Inverse-witness inequality bit (field.rs:is_neq)."""
        xv, yv = x.value(cs), y.value(cs)
        bit = BinaryAssignment.witness(cs, 1 if xv != yv else 0)
        if xv != yv:
            mult = cls.witness(cs, pow((xv - yv) % cs.p, -1, cs.p))
        else:
            mult = cls.witness(cs, 1)
        diff = x - y
        m = cls.mul(cs, diff, mult)
        cls.enforce_eq(cs, m, cls.from_binary_in(cs, bit))
        not_bit = BinaryAssignment.not_(cs, bit)
        m2 = cls.mul(cs, diff, cls.from_binary_in(cs, not_bit))
        cls.enforce_eq_constant(cs, m2, 0)
        return bit

    @classmethod
    def is_eq(cls, cs, x, y) -> BinaryAssignment:
        return BinaryAssignment.not_(cs, cls.is_neq(cs, x, y))

    # -- bit decomposition + range checks ----------------------------------
    @classmethod
    def to_bits(cls, cs, x, num_bits: int = 256):
        """BE bit witnesses of x's value + range check (field.rs:to_bits)."""
        assert num_bits <= 256
        val = x.value(cs)
        all_bits = [(val >> (255 - i)) & 1 for i in range(256)]
        bits = [BinaryAssignment.witness(cs, b) for b in all_bits[256 - num_bits:]]
        if num_bits < cs.driver.num_bits:
            cls.range_check_bits(cs, bits, num_bits)
        else:
            cls.range_check(cs, bits, cs.p - 1)
        return bits

    @classmethod
    def range_check_bits(cls, cs, a_bits, num_bits: int):
        cls.range_check(cs, a_bits, (1 << num_bits) - 1)

    @classmethod
    def range_check(cls, cs, a_bits, c: int):
        """Constrain BE bits `a_bits` to encode a value <= c (field.rs:range_check).

        Bellman-style: booleanity for positions where c's bit is 1; where c's
        bit is 0, enforce bit * (1 - bit - p_{i-1}) = 0 with p the running
        product of a's bits at c's leading-one positions.
        """
        c_bits_full = [(c >> (255 - i)) & 1 for i in range(256)]
        # strip leading zeros
        try:
            first_one = c_bits_full.index(1)
        except ValueError:
            first_one = len(c_bits_full)
        c_bits = c_bits_full[first_one:]

        if len(a_bits) < len(c_bits):
            return

        lead = len(a_bits) - len(c_bits)
        for bit in a_bits[:lead]:
            cls.enforce_eq_constant(cs, cls.from_binary_in(cs, bit), 0)
        a_bits = a_bits[lead:]

        p_run = [cls.from_binary_in(cs, a_bits[0])]
        # index of last non-one bit in c (or len-1 if all ones)
        t = len(c_bits) - 1
        for i in range(len(c_bits) - 1, -1, -1):
            if c_bits[i] != 1:
                t = i
                break

        for a_bit, c_bit in zip(a_bits[1:], c_bits[1: t + 2]):
            if c_bit == 1:
                p_run.append(cls.mul(cs, p_run[-1], cls.from_binary_in(cs, a_bit)))
            else:
                p_run.append(p_run[-1])

        one = cls.constant(cs, 1)
        for i, (a_bit, c_bit) in enumerate(zip(a_bits, c_bits)):
            bf = cls.from_binary_in(cs, a_bit)
            if c_bit == 1:
                constr = cls.mul(cs, bf - one, bf)
                cls.enforce_eq_constant(cs, constr, 0)
            elif c_bit == 0:
                constr = cls.mul(cs, (one - bf) - p_run[i - 1], bf)
                cls.enforce_eq_constant(cs, constr, 0)

    @classmethod
    def enforce_eq_bits(cls, cs, x, bits):
        """x == sum 2^i bits[i] (bits BE)."""
        f = 1
        acc = cls.constant(cs, 0)
        for bit in reversed(bits):
            acc = acc + cls.mul(cs, cls.constant(cs, f), cls.from_binary_in(cs, bit))
            f = f * 2 % cs.p
        cls.enforce_eq(cs, x, acc)
