"""Groth16 proofs of the square-chain circuit, one after another.

Set-up: the circuit at 2^constraints_log2 constraints, `groth16.setup` with
the toxic waste drawn from the seed, then `warmup` proofs. A request is
`Prover.create_proof` for a fresh public seed x0 with fresh blinding (r, s),
both from the seed; its answer is the proof's three points on the host.
The reference works every proof out again in closed form
(`reference/groth16.py`) and the check counts the proofs that differ.
"""

from __future__ import annotations

import contextlib

from kogarashi_tpu_torch.groth16 import SquareChainCircuit, setup
from kogarashi_tpu_torch.groth16 import prover as prover_mod

from ..inputs import R, stream
from ..reference.groth16 import SquareChainProofs, blinding, toxic_waste
from .common import CONTROL_BITS, affine, patched, plain, sync


class Driver:
    def __init__(self, config, traffic, seed, device):
        self.m = 1 << config["constraints_log2"]
        self.traffic, self.seed, self.device = traffic, seed, device
        self.work = None
        self.mode = None
        self.ref = None

    def x0(self, i: int) -> int:
        return stream(self.seed, "x0", i).randrange(2, R)

    def setup(self):
        circuit = SquareChainCircuit(self.m, x0=self.x0(-1))
        self.prover, _ = setup(circuit, stream(self.seed, "toxic"), device=self.device)
        if self.mode == "control":
            self.ref = SquareChainProofs(self.m, toxic_waste(stream(self.seed, "toxic")))
        for w in range(self.traffic["warmup"]):
            self.request(-2 - w)

    def request(self, i: int):
        x0, rng = self.x0(i), stream(self.seed, "rs", i)
        if self.mode == "control":
            a, b, c = self.ref.proof(x0, *blinding(rng), bits=CONTROL_BITS)
            return i, (a + (False,), b + (False,), c + (False,))
        proof = self.prover.create_proof(SquareChainCircuit(self.m, x0=x0), rng)
        sync(self.device)
        if self.mode == "altered":
            proof.c = proof.c + proof.c.spec.generator
        return i, (plain(proof.a), plain(proof.b), plain(proof.c))

    def release(self):
        self.prover = None

    def check(self, answers):
        n = self.traffic["check_sample"]
        picked = answers if len(answers) <= n else stream(self.seed, "sample").sample(answers, n)
        ref = self.ref or SquareChainProofs(self.m, toxic_waste(stream(self.seed, "toxic")))
        wrong = 0
        for i, got in picked:
            want = ref.proof(self.x0(i), *blinding(stream(self.seed, "rs", i)))
            wrong += any(affine(g) != w for g, w in zip(got, want))
        return [("proofs_wrong", wrong, 0)], wrong

    def control(self):
        self.mode = "control"
        return contextlib.nullcontext()

    def fault(self, name):
        if name == "altered":
            self.mode = "altered"
            return contextlib.nullcontext()
        if name == "half":
            real = prover_mod.msm

            def half_msm(curve, x, y, inf, scalars, c=None):
                s = scalars.clone()
                s[:, s.shape[1] // 2:] = 0
                return real(curve, x, y, inf, s, c)

            return patched(prover_mod, "msm", half_msm)
        raise KeyError(name)
