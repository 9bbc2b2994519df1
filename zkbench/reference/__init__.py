"""Plain references that decide `correct`: Python integers and NumPy only.

Nothing here imports the port (`kogarashi_tpu_torch`), JAX or the JAX
package; `tests/test_zkbench_guard.py` checks it. `ec` is a plain curve
oracle, `groth16` works a proof out in closed form from the toxic waste,
`msm` an MSM from its bases' discrete logs, and `nova` judges a Nova chain's
final state with the decider's relations on its own synthesis of the
augmented circuits (`nova/circuit/`, a frozen copy of the port's host code).
"""
