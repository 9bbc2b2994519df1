"""0/1 wire gadget. Parity: zkstd/src/circuit/gadget/binary.rs.

Like the reference, `not_`/`and_` allocate fresh witnesses without boolean
constraints (the reference marks this TODO); boolean-ness is enforced where
bits are produced (FieldAssignment.to_bits range check).
"""

from __future__ import annotations


class BinaryAssignment:
    __slots__ = ("wire",)

    def __init__(self, wire):
        self.wire = wire

    @classmethod
    def instance(cls, cs, bit: int):
        wire = cs.public_wire()
        cs.x.append(bit % cs.p)
        return cls(wire)

    @classmethod
    def witness(cls, cs, bit: int):
        wire = cs.private_wire()
        cs.w.append(bit % cs.p)
        return cls(wire)

    @classmethod
    def not_(cls, cs, b: "BinaryAssignment"):
        wire = cs.private_wire()
        cs.w.append(0 if cs.wire_value(b.wire) == 1 else 1)
        return cls(wire)

    @classmethod
    def and_(cls, cs, a: "BinaryAssignment", b: "BinaryAssignment"):
        wire = cs.private_wire()
        val = 1 if (cs.wire_value(a.wire) == 1 and cs.wire_value(b.wire) == 1) else 0
        cs.w.append(val)
        return cls(wire)

    @classmethod
    def conditional_enforce_equal(cls, cs, x, y, should_enforce):
        from .field import FieldAssignment

        FieldAssignment.conditional_enforce_equal(
            cs,
            FieldAssignment.from_binary_in(cs, x),
            FieldAssignment.from_binary_in(cs, y),
            should_enforce,
        )

    def value(self, cs) -> int:
        return cs.wire_value(self.wire)
