"""A Nova IVC chain on one card: setup, N prove_steps, checks.

    python -m kogarashi_tpu_torch.benches.ivc_chain [--device cpu] [--out PATH]

Counterpart of `benches/ivc_chain.py` (which times the JAX package):
`PublicParams.setup(ExampleFunction, ExampleFunction, random.Random(99))`,
`Ivc(pp, z0_primary=[0], z0_secondary=[0])` and N `prove_step`s (every
commitment an MSM on the card: G1 for the primary, Grumpkin for the
secondary). Then, as the original (:57-66): the final proof verifies, the
chain's state is the N-fold z -> z^3 + z + 5 from 0, and the proof with a
changed z_i is rejected. Prints one JSON line with the original's keys
(`steps_per_s` = N / the chain's seconds; `steady_step_s` = the mean of
steps 3 onward, past the base case and the first fold; `backend` is the
card's name), and writes it to a file only when given `--out PATH`.

Env: KOGARASHI_IVC_STEPS (default 10), KOGARASHI_IVC_VERIFY_EVERY (0: verify
only at the end; k: also after every k-th step).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import random
import sys
import time
from pathlib import Path

from .. import constants as C
from ..devices import backend_name, describe, resolve, synchronize
from ..nova import ExampleFunction, Ivc, PublicParams

SEED = 99  # random.Random seed of the keys (`benches/ivc_chain.py:37`)
CUT_AT = 5  # steps after which `cap_s` may end the chain


def chain_state(i: int) -> list[int]:
    """z_i of ExampleFunction's chain from z_0 = 0: i times z -> z^3 + z + 5 mod r."""
    z = 0
    for _ in range(i):
        z = (z**3 + z + 5) % C.R
    return [z]


def run(n_steps=None, device=None, verify_every=None, cap_s=None, around_steps=None):
    """Setup and an n_steps chain on `device` (None: the card); arguments
    left None read KOGARASHI_IVC_STEPS (10) and KOGARASHI_IVC_VERIFY_EVERY
    (0). With `cap_s`, the chain stops after CUT_AT steps when setup plus
    n_steps at their pace would take longer than cap_s seconds.
    `around_steps`, a context manager, is entered around the steps alone.
    Raises if a check fails. Returns (record, detail): record is the JSON
    object, detail holds step_s (each step's seconds) and verify_s."""
    env = os.environ.get
    n_steps = int(env("KOGARASHI_IVC_STEPS", "10")) if n_steps is None else n_steps
    verify_every = int(env("KOGARASHI_IVC_VERIFY_EVERY", "0")) if verify_every is None else verify_every
    device = resolve(device)

    t0 = time.perf_counter()
    pp = PublicParams.setup(ExampleFunction, ExampleFunction, random.Random(SEED), device=device)
    synchronize(device)
    t_setup = time.perf_counter() - t0
    print(f"# setup {t_setup:.3f}s", file=sys.stderr)

    ivc = Ivc(pp, z0_primary=[0], z0_secondary=[0])
    step_times, proof = [], None
    t_chain0 = time.perf_counter()
    with around_steps or contextlib.nullcontext():
        while len(step_times) < n_steps:
            t0 = time.perf_counter()
            proof = ivc.prove_step()
            synchronize(device)
            step_times.append(time.perf_counter() - t0)
            s = len(step_times)
            if s <= 3 or s % 25 == 0:
                print(f"# step {s}/{n_steps}: {step_times[-1]:.3f}s", file=sys.stderr)
            if verify_every and s % verify_every == 0 and not proof.verify(pp):
                raise AssertionError(f"proof failed at step {s}")
            if cap_s is not None and s == CUT_AT and t_setup + sum(step_times) * n_steps / s > cap_s:
                n_steps = s
    t_chain = time.perf_counter() - t_chain0

    t0 = time.perf_counter()
    if not proof.verify(pp):
        raise AssertionError("final proof failed")
    t_verify = time.perf_counter() - t0
    if ivc.zi_primary != chain_state(proof.i) or proof.i != n_steps:
        raise AssertionError(f"chain state drifted: z_i {ivc.zi_primary} after {proof.i} steps")
    proof.zi_primary = [(proof.zi_primary[0] + 1) % C.R]
    if proof.verify(pp):
        raise AssertionError("tampered proof verified")

    steady = step_times[2:] or step_times  # past the base case and the first fold
    record = {
        "metric": "nova_ivc_chain",
        "steps": n_steps,
        "setup_s": t_setup,
        "chain_s": t_chain,
        "steps_per_s": n_steps / t_chain,
        "steady_step_s": sum(steady) / len(steady),
        "final_verified": True,
        "tamper_rejected": True,
        "backend": backend_name(device),
    }
    return record, {"step_s": step_times, "verify_s": t_verify}


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
