"""Groth16 at 2^LOG_M constraints on one card: setup, prove, verify.

    python -m kogarashi_tpu_torch.benches.groth16_large [--device cpu] [--out PATH]

Counterpart of `benches/groth16_large.py` (which times the JAX package):
builds `SquareChainCircuit(2^LOG_M)`, runs setup from random.Random(0x5E7)
and one proof from random.Random(0xBEEF) on the card (fixed-base queries on
K3, the prover's MSMs on K1-K4), verifies it with the host pairing (as the
JAX package's verifier does), and checks that a changed last public input
is rejected. Prints one JSON line with the original's keys (`metric`,
`constraints`, `setup_s`, `prove_s`, `verify_s`, `verified`,
`tamper_rejected`, `backend`; `backend` is the card's name), and writes it
to a file only when given `--out PATH`.

Env: KOGARASHI_GROTH16_LOG_M (default 20).
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import time
from pathlib import Path

from ..devices import backend_name, describe, resolve, synchronize
from ..groth16 import SquareChainCircuit, setup

SETUP_SEED = 0x5E7  # `benches/groth16_large.py:47`
PROVE_SEED = 0xBEEF  # :52


def run(log_m=None, device=None):
    """Setup, prove and verify SquareChainCircuit(2^log_m) on `device` (None:
    the card); log_m None reads KOGARASHI_GROTH16_LOG_M (default 20).
    Raises if the proof does not verify or a changed public input does.
    Returns (record, (proof, public inputs, verifier))."""
    if log_m is None:
        log_m = int(os.environ.get("KOGARASHI_GROTH16_LOG_M", "20"))
    device = resolve(device)
    m = 1 << log_m
    circuit = SquareChainCircuit(m)
    cs = circuit.build()
    print(f"# circuit: square chain, m={cs.m} constraints, {cs.l() + cs.m_l_1()} wires", file=sys.stderr)

    t0 = time.perf_counter()
    prover, verifier = setup(circuit, random.Random(SETUP_SEED), device=device)
    synchronize(device)
    t_setup = time.perf_counter() - t0
    print(f"# setup: {t_setup:.3f}s", file=sys.stderr)

    t0 = time.perf_counter()
    proof = prover.create_proof(circuit, random.Random(PROVE_SEED))
    t_prove = time.perf_counter() - t0
    print(f"# prove: {t_prove:.3f}s", file=sys.stderr)

    inputs = cs.x[1:]
    t0 = time.perf_counter()
    ok = verifier.verify(proof, inputs)
    t_verify = time.perf_counter() - t0
    if not ok:
        raise AssertionError("proof did not verify")
    bad = list(inputs)
    bad[-1] = (bad[-1] + 1) % cs.p  # a wrong public output
    if verifier.verify(proof, bad):
        raise AssertionError("tampered inputs verified")

    record = {
        "metric": f"groth16_prove_2^{log_m}_constraints",
        "constraints": m,
        "setup_s": t_setup,
        "prove_s": t_prove,
        "verify_s": t_verify,
        "verified": True,
        "tamper_rejected": True,
        "backend": backend_name(device),
    }
    return record, (proof, inputs, verifier)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--out", type=Path, default=None, help="also write the JSON record here")
    args = ap.parse_args(argv)
    device = resolve(args.device)
    record, _ = run(device=device)
    if args.out is not None:
        args.out.write_text(json.dumps(record, indent=1))
    print(json.dumps(record), flush=True)
    print(f"# device={describe(device)}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
