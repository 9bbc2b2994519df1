"""Benchmark of the PyTorch/CUDA prover `kogarashi_tpu_torch` on one card.

    python3 -m zkbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cells are read from `BENCHMARK.json` at the checkout's root; each cell's
configuration (`configs/<name>.json`), traffic mix (`traffic/<name>.json`),
request driver (`drivers/<op>.py`, named by the mix) and metric readers
(`metrics/<name>.py`) are found by name. `README.md` says how to add one.
Nothing here imports JAX or the JAX package; `reference/` imports nothing of
the port either.
"""
