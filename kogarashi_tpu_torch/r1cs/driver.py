"""The circuit driver of Groth16 over BN254.

Parity: zkstd/src/circuit.rs (CircuitDriver trait), groth16/src/circuit.rs
(Bn254Driver). The port's own copy of the part of
`kogarashi_tpu/r1cs/driver.py` it uses: constraints over Fr with Fq as the
companion field. The in-circuit curve (Grumpkin) and the Grumpkin driver
serve only the JAX package's Nova and are left out.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..pyref import Fq, Fr


@dataclass(frozen=True)
class Driver:
    name: str
    scalar: type  # constraint field (pyref PrimeField subclass)
    base: type  # companion field
    num_bits: int = 254

    @property
    def order_str(self) -> str:
        return f"{self.scalar.p:064x}"


# Constraints over Fr.
BN254_DRIVER = Driver(name="bn254", scalar=Fr, base=Fq)
