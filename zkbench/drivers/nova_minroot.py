"""Nova folding steps of a MinRoot VDF chain on the BN254 <-> Grumpkin cycle,
as microsoft/Nova's examples/minroot.rs proves it: `iterations_per_step`
rounds of MinRoot a step on the primary curve, the trivial step on the
secondary.

Set-up: `PublicParams.setup` on a shape-only `MinRootFunction` and
`TrivialFunction`, with Pedersen keys drawn from the seed as the
`nova_fold` driver draws them; the advice of `advice_steps` steps, made
backward from an end state drawn from the seed (`reference/minroot.py`),
which gives z_0; `Ivc` from z_0 with step 0's advice; then `warmup` steps
(the base case and the first fold). A request is one `Ivc.prove_step` with
that step's advice. Once the window has closed, the reference's decider
judges the chain's final state.
"""

from __future__ import annotations

import contextlib
import sys

from kogarashi_tpu_torch.nova import Ivc, MinRootFunction, PublicParams, TrivialFunction
from kogarashi_tpu_torch.nova.pedersen import PedersenCommitment

from ..inputs import Q, R, stream
from ..reference import minroot as ref
from ..reference import nova
from ..reference.ec import G1, GRUMPKIN
from .common import CONTROL_BITS, patched, sync
from . import nova_fold
from .nova_fold import KeyStream


class Driver(nova_fold.Driver):
    def __init__(self, config, traffic, seed, device):
        super().__init__(config, traffic, seed, device)
        self.iterations = config["iterations_per_step"]
        self._decider = None

    def setup(self):
        pp = PublicParams.setup(MinRootFunction(self.iterations), TrivialFunction, KeyStream(self.seed),
                                device=self.device)
        z = stream(self.seed, "z")
        end = (z.randrange(R), z.randrange(R))
        z0, self.hints = ref.chain_backward(end, self.iterations, self.traffic["advice_steps"])
        self.ivc = Ivc(pp, z0_primary=list(z0), z0_secondary=[z.randrange(Q)], primary=self.step(0))
        for w in range(self.traffic["warmup"]):
            self.request(-1 - w)

    def step(self, s: int) -> MinRootFunction:
        """Step s's primary step function, with its advice."""
        if s >= len(self.hints):
            raise RuntimeError(f"step {s} asked for, advice made for {len(self.hints)} steps (advice_steps)")
        return MinRootFunction(self.iterations, self.hints[s])

    def request(self, i: int):
        self.last = self.ivc.prove_step(primary=self.step(self.ivc.i))
        sync(self.device)
        self.steps += 1
        return self.last.i

    def release(self):
        super().release()
        self.hints = None

    def decider(self) -> ref.Decider:
        if self._decider is None:
            self._decider = ref.Decider(self.iterations)
        return self._decider

    def check(self, answers):
        """One number: the decider's failed relations, summed over its four
        kinds (each printed on stderr)."""
        decider = self.decider()
        counts = decider.check(self.state, self.steps, decider.key_scalars(KeyStream(self.seed).rng))
        print("# decider: " + ", ".join(f"{k} {v}" for k, v in counts.items()), file=sys.stderr)
        total = sum(counts.values())
        return [("chain_failures", total, 0)], int(total > 0)

    def control(self):
        """Every commit the reference's opening in 240-bit scalars."""
        k1, k2 = self.decider().key_scalars(KeyStream(self.seed).rng)
        keys = {"G1": (G1, k1), "Grumpkin": (GRUMPKIN, k2)}

        def commit(ck, msg):
            curve, dlogs = keys[ck.spec.name]
            pt = nova.commit(curve, dlogs, list(msg), bits=CONTROL_BITS)
            if pt is None:
                return ck.spec.identity_affine()
            F = ck.spec.field
            return type(ck.spec.generator)(ck.spec, F(pt[0]), F(pt[1]), False)

        return patched(PedersenCommitment, "commit", commit)

    @contextlib.contextmanager
    def _bad_hint(self):
        """One hint of the window's first step off by one."""
        step, k = self.hints[self.ivc.i], self.iterations // 2
        real = step[k]
        step[k] = (real + 1) % R
        try:
            yield
        finally:
            step[k] = real

    def fault(self, name):
        if name == "bad_advice":
            return self._bad_hint()
        if name == "unchanged":
            proof = self.ivc._proof
            return patched(self.ivc, "prove_step", lambda **_: proof())
        return super().fault(name)
