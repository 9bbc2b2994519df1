"""Step-function interface for IVC (parity: nova/src/function.rs).

The port's own copy of `kogarashi_tpu/nova/function.py`.
"""

from __future__ import annotations

from abc import ABC, abstractmethod


class FunctionCircuit(ABC):
    """A step function F with a native and an in-circuit evaluation.

    Both operate over the given driver's scalar field (ints / gadgets).
    """

    @staticmethod
    @abstractmethod
    def invoke(z_i: list[int], p: int) -> list[int]:
        ...

    @staticmethod
    @abstractmethod
    def invoke_cs(cs, z_i: list) -> list:
        ...


class ExampleFunction(FunctionCircuit):
    """z -> z^3 + z + 5 (parity: nova/src/test.rs:10-30 fixture)."""

    @staticmethod
    def invoke(z_i, p):
        z = z_i[0]
        return [(z**3 + z + 5) % p]

    @staticmethod
    def invoke_cs(cs, z_i):
        from ..r1cs import FieldAssignment as FA

        z = z_i[0]
        z_sq = FA.mul(cs, z, z)
        z_cu = FA.mul(cs, z_sq, z)
        five = FA.constant(cs, 5)
        return [(z_cu + z) + five]
