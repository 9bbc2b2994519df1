from .bignat import (
    BigNatAssignment,
    Polynomial,
    f_to_nat,
    limbs_to_nat,
    nat_to_f,
    nat_to_limbs,
)
from .mimc import MimcAssignment, MimcROCircuit
from .instance import R1csInstanceAssignment, RelaxedR1csInstanceAssignment
from .nifs import NifsCircuit

__all__ = [
    "BigNatAssignment",
    "Polynomial",
    "f_to_nat",
    "limbs_to_nat",
    "nat_to_f",
    "nat_to_limbs",
    "MimcAssignment",
    "MimcROCircuit",
    "R1csInstanceAssignment",
    "RelaxedR1csInstanceAssignment",
    "NifsCircuit",
]
