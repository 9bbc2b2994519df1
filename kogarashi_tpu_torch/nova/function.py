"""Step-function interface for IVC (parity: nova/src/function.rs, and the
`StepCircuit` of microsoft/Nova for step circuits with advice).

The port's own copy of `kogarashi_tpu/nova/function.py`, with step circuits
that declare their arity and may carry per-step advice: `ExampleFunction`
and `TrivialFunction` are classes of static methods, `MinRootFunction` an
instance holding its step's hints. `synthesize` runs a step function inside
the augmented circuit, counts what it consumed in `COUNTS` and marks its
time (INFO, "nova <side> step synthesis"); `count_synthesis` counts a whole
augmented circuit's constraints there by the kind of system.
"""

from __future__ import annotations

import logging
from abc import ABC, abstractmethod

from ..r1cs import WitnessCS
from ..stages import Stages

LOG = logging.getLogger(__name__)

# steps synthesized, and the constraints and advice entries they consumed;
# the constraints of whole augmented circuits, synthesized values only (a
# WitnessCS) and with their rows (an R1CS)
COUNTS: dict = {"steps": 0, "constraints": 0, "advice": 0,
                "constraints_witness_only": 0, "constraints_with_rows": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def count_synthesis(cs, m: int) -> None:
    """m constraints synthesized into `cs`, counted by its kind."""
    COUNTS["constraints_witness_only" if isinstance(cs, WitnessCS) else "constraints_with_rows"] += m


def synthesize(fc, cs, z_i: list, side: str) -> list:
    """z_next = fc.invoke_cs(cs, z_i), counted and marked."""
    st = Stages(LOG, "nova", "cpu")
    m = cs.m
    z_next = fc.invoke_cs(cs, z_i)
    COUNTS["steps"] += 1
    COUNTS["constraints"] += cs.m - m
    COUNTS["advice"] += len(getattr(fc, "advice", None) or ())
    st.mark(f"{side} step synthesis")
    return z_next


class FunctionCircuit(ABC):
    """A step function F with a native and an in-circuit evaluation.

    Both operate over the given driver's scalar field (ints / gadgets); the
    state z has `arity` elements.
    """

    arity = 1

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


class TrivialFunction(FunctionCircuit):
    """z -> z, no constraints (microsoft/Nova's `TrivialCircuit`)."""

    @staticmethod
    def invoke(z_i, p):
        return [v % p for v in z_i]

    @staticmethod
    def invoke_cs(cs, z_i):
        return list(z_i)


class MinRootFunction(FunctionCircuit):
    """`iterations` rounds of MinRoot (Khovratovich, Maller and Tiwari,
    ePrint 2022/1626) a step, (x, y) -> ((x + y)^(1/5), x), as
    microsoft/Nova's examples/minroot.rs proves it.

    The fifth roots are the step's advice: `advice` lists its x_{k+1}, one a
    round (None: zeros, enough to freeze the shape). In the circuit each
    round allocates its hint and enforces hint^4 * hint = x + y, three
    constraints, and y_{k+1} = x_k costs nothing; a wrong hint leaves the
    instance unsatisfied.
    """

    arity = 2

    def __init__(self, iterations: int, advice: list | None = None):
        if advice is not None and len(advice) != iterations:
            raise ValueError(f"{len(advice)} hints for {iterations} iterations")
        self.iterations = iterations
        self.advice = advice

    @staticmethod
    def fifth_roots(z_i: list, iterations: int, p: int) -> list[int]:
        """The x_{k+1} of `iterations` rounds from z_i, forward: a fifth root
        is a power by 5^-1 mod (p - 1) (gcd(5, p - 1) = 1 on BN254's Fr and
        Fq, so x -> x^5 is a bijection)."""
        e = pow(5, -1, p - 1)
        x, y = (v % p for v in z_i)
        roots = []
        for _ in range(iterations):
            x, y = pow((x + y) % p, e, p), x
            roots.append(x)
        return roots

    def invoke(self, z_i, p):
        xs = [z_i[0] % p] + self.fifth_roots(z_i, self.iterations, p)
        return [xs[-1], xs[-2]] if self.iterations else [v % p for v in z_i]

    def invoke_cs(self, cs, z_i):
        from ..r1cs import FieldAssignment as FA

        x, y = z_i
        for hint in self.advice if self.advice is not None else [0] * self.iterations:
            x1 = FA.witness(cs, hint)
            quad = FA.square(cs, FA.square(cs, x1))
            cs.mul_gate(quad.lc, x1.lc, (x + y).lc)
            x, y = x1, x
        return [x, y]
