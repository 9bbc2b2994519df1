"""Circuit drivers for the BN254 <-> Grumpkin cycle.

The port's own copy of `kogarashi_tpu/r1cs/driver.py`. Parity:
zkstd/src/circuit.rs (CircuitDriver trait), nova/src/driver.rs and
groth16/src/circuit.rs (Bn254Driver / GrumpkinDriver).

A driver fixes: the constraint (scalar) field, the companion base field, the
curve arithmetized *inside* circuits over the scalar field (its base field is
the scalar field: Grumpkin for Bn254Driver, BN254 G1 for GrumpkinDriver —
hence b3() = the partner curve's 3b), and ORDER_STR (the scalar modulus hex,
consumed by the BigNat gadget for non-native arithmetic).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..pyref import Fq, Fr, G1_SPEC, GRUMPKIN_SPEC
from ..pyref.curve import CurveSpec


@dataclass(frozen=True)
class Driver:
    name: str
    scalar: type  # constraint field (pyref PrimeField subclass)
    base: type  # companion field
    curve: CurveSpec  # in-circuit curve: curve.field is the scalar field
    num_bits: int = 254

    @property
    def order_str(self) -> str:
        return f"{self.scalar.p:064x}"

    @property
    def commit_curve(self) -> CurveSpec:
        """Curve for witness-vector commitments: scalar field == self.scalar,
        coordinates in self.base (G1 for Bn254Driver, Grumpkin for
        GrumpkinDriver) — nova/src/driver.rs `Affine` assoc type."""
        return G1_SPEC if self.scalar is Fr else GRUMPKIN_SPEC

    def b3(self) -> int:
        """3 * b of the in-circuit curve, as a scalar-field int."""
        return 3 * self.curve.b.v % self.scalar.p


# Constraints over Fr; in-circuit curve Grumpkin (base field Fr).
BN254_DRIVER = Driver(name="bn254", scalar=Fr, base=Fq, curve=GRUMPKIN_SPEC)
# Constraints over Fq; in-circuit curve BN254 G1 (base field Fq).
GRUMPKIN_DRIVER = Driver(name="grumpkin", scalar=Fq, base=Fr, curve=G1_SPEC)


def scalar_as_base(driver: Driver, v: int) -> int:
    """Bit-reinterpret a scalar-field value in the base field
    (nova/src/driver.rs:45). Values < min(p, q) are preserved."""
    return v % driver.base.p


def base_as_scalar(driver: Driver, v: int) -> int:
    """Bit-reinterpret a base-field value in the scalar field
    (nova/src/driver.rs:58)."""
    return v % driver.scalar.p
