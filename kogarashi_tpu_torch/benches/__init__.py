"""The port's counterparts of the repo's `benches/` drivers.

Each module times the port on the workload of the script of the same name
in `benches/` (which times the JAX package), holds its result to that
script's checks, and prints the same JSON keys:
  groth16_large  SquareChainCircuit(2^LOG_M): setup, prove, verify, a tamper
  ivc_chain      a Nova chain with random.Random(99) keys: steps/s, checks
  microbench     the per-op matrix: field, curve, MSM, NTT, SpMV, MiMC
Run each as `python -m kogarashi_tpu_torch.benches.<name>`; it runs on the
card unless given `--device cpu`. Importing a module does nothing else.
"""
