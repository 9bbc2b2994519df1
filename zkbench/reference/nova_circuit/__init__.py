"""A frozen copy of the port's host-side circuit code (Python integers only):
BN254 and Grumpkin constants, the field and curve oracle, MiMC, the R1CS
constraint system with its gadgets, and Nova's augmented step circuit. The decider
(`reference/nova.py`) synthesizes the two augmented circuits with it to get
the constraint matrices that the port's chain must satisfy, so the matrices
are worked out here and never read from the program.

Copied from `kogarashi_tpu_torch/` (constants.py, pyref/{field,curve,mimc}.py,
r1cs/, nova/{augmented,function}.py, nova/gadgets/) with G2, the device
products and the commitments left out (`nova/relaxed_r1cs.py` keeps only the
instance types). A later change to the program's circuit is a change of the
statement proved, and this copy is then what holds it to the old one.
"""
