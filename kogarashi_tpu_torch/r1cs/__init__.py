"""Host-side R1CS constraint system (the port's own copy of the parts of
`kogarashi_tpu/r1cs` that Groth16 uses).

Constraint synthesis is pointer-chasing sparse work and stays on the host
(Python ints), mirroring the reference semantics (zkstd/src/r1cs.rs,
zkstd/src/matrix/). SpMV, NTT and MSM consume the exported COO arrays on the
device.
"""

from .system import R1CS, Wire, LinComb, ONE
from .driver import Driver, BN254_DRIVER
from .gadgets.field import FieldAssignment
from .gadgets.binary import BinaryAssignment

__all__ = [
    "R1CS",
    "Wire",
    "LinComb",
    "ONE",
    "Driver",
    "BN254_DRIVER",
    "FieldAssignment",
    "BinaryAssignment",
]
