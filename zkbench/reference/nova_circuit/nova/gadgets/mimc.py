"""In-circuit MiMC hash and Fiat-Shamir sponge.

The port's own copy of `kogarashi_tpu/nova/gadgets/mimc.py`.

Parity: nova/src/gadget/mimc.rs (MimcAssignment), circuit/transcript.rs
(MimcROCircuit). Same chained-Blake2b constants as the native hasher.
"""

from __future__ import annotations

from ...pyref.mimc import mimc_constants
from ...r1cs.gadgets.field import FieldAssignment as FA


class MimcAssignment:
    """x^7 Feistel over the constraint field."""

    def __init__(self, field):
        self.constants = [c.v for c in mimc_constants(field)]

    def hash(self, cs, xl: FA, xr: FA) -> FA:
        for c_val in self.constants:
            c = FA.constant(cs, c_val)
            cxl = xl + c
            ccxl = FA.square(cs, cxl)
            cccxl = FA.square(cs, ccxl)
            ccccxl = FA.mul(cs, cccxl, ccxl)
            ccccxl = FA.mul(cs, ccccxl, cxl) + xr
            xr = xl
            xl = ccccxl
        return xl


class MimcROCircuit:
    """In-circuit sponge; mirrors the native MimcRO fold + low-bits squeeze."""

    def __init__(self, field):
        self.hasher = MimcAssignment(field)
        self.state: list[FA] = []

    def append(self, x: FA):
        self.state.append(x)

    def append_vec(self, xs):
        self.state.extend(xs)

    def append_point(self, point):
        """(x, y, z) — callers descale first where the native side absorbs
        affine coordinates (transcript.rs:33)."""
        self.append(point.x)
        self.append(point.y)
        self.append(point.z)

    def squeeze(self, cs, num_bits: int) -> FA:
        acc = FA.constant(cs, 0)
        for s in self.state:
            h = self.hasher.hash(cs, s, acc)
            acc = (acc + s) + h
        bits = FA.to_bits(cs, acc, num_bits)
        mult = FA.constant(cs, 1)
        val = FA.constant(cs, 0)
        for bit in reversed(bits[-num_bits:]):
            val = FA.conditional_select(cs, val + mult, val, bit)
            mult = mult + mult
        return val
