"""Groth16 over BN254 on the port: setup -> prove -> verify.

Parity: groth16/src/{zksnark,prover,verifier,proof,params}.rs and the JAX
package's `kogarashi_tpu/groth16`. `SquareChainCircuit` (the 2^20-constraint
benchmark circuit, the port's copy of `kogarashi_tpu/r1cs/vector.py`) is
re-exported for callers of the port.
"""

from ..r1cs.vector import SquareChainCircuit
from .circuit import Circuit
from .keys import Parameters, PreparedVerifyingKey, Proof, Verifier, VerifyingKey
from .prover import Prover
from .setup import setup

__all__ = [
    "Circuit",
    "Parameters",
    "PreparedVerifyingKey",
    "Proof",
    "Prover",
    "SquareChainCircuit",
    "Verifier",
    "VerifyingKey",
    "setup",
]
