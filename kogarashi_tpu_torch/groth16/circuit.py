"""Circuit interface (parity: groth16/src/circuit.rs:10, `Circuit` trait).

Setup and the prover read circuits by duck typing (`circuit.build()`), so
the JAX package's circuits and `kogarashi_tpu.r1cs.vector.SquareChainCircuit`
work unchanged.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

from ..r1cs import BN254_DRIVER, R1CS


class Circuit(ABC):
    """Subclass with a `synthesize(cs)` writing constraints over Fr."""

    driver = BN254_DRIVER

    @abstractmethod
    def synthesize(self, cs: R1CS) -> None:
        ...

    def build(self) -> R1CS:
        cs = R1CS(self.driver)
        self.synthesize(cs)
        return cs
