"""Host-side R1CS constraint system (the port's own copy of
`kogarashi_tpu/r1cs`).

Constraint synthesis is pointer-chasing sparse work and stays on the host
(Python ints), mirroring the reference semantics (zkstd/src/r1cs.rs,
zkstd/src/matrix/); `WitnessCS` takes the same gadget calls and keeps only
the values, for a circuit whose shape is already frozen. SpMV, NTT and MSM
consume the exported COO arrays on the device.
"""

from .system import ONE, LinComb, R1CS, Wire, WitnessCS
from .driver import Driver, BN254_DRIVER, GRUMPKIN_DRIVER
from .gadgets.field import FieldAssignment
from .gadgets.binary import BinaryAssignment
from .gadgets.curve import PointAssignment

__all__ = [
    "R1CS",
    "WitnessCS",
    "Wire",
    "LinComb",
    "ONE",
    "Driver",
    "BN254_DRIVER",
    "GRUMPKIN_DRIVER",
    "FieldAssignment",
    "BinaryAssignment",
    "PointAssignment",
]
