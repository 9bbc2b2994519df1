"""Nova folding steps of one IVC chain on the BN254 <-> Grumpkin cycle.

Set-up: `PublicParams.setup` with Pedersen keys whose points are the
generator times scalars drawn from the seed (the form of the upstream
project's `pedersen.rs`; the port builds them on the device), `Ivc` from
z_0 drawn from the seed, then `warmup` steps (the base case and the first
fold). A request is one `Ivc.prove_step`. Once the window has closed, the
reference's decider (`reference/nova.py`) judges the chain's final state.
"""

from __future__ import annotations

import sys

from kogarashi_tpu_torch.nova import ExampleFunction, Ivc, PublicParams
from kogarashi_tpu_torch.nova.pedersen import PedersenCommitment

from ..inputs import Q, R, stream
from ..reference import nova as ref
from ..reference.ec import G1, GRUMPKIN
from .common import CONTROL_BITS, patched, plain, sync


class KeyStream:
    """The key points' scalars, uniform in [1, order) from the seed. The port
    takes a key stream with `field_random(order)` and makes each point as
    the generator times it."""

    def __init__(self, seed: int):
        self.rng = stream(seed, "keys")

    def field_random(self, order: int) -> int:
        return self.rng.randrange(1, order)


def plain_state(proof) -> dict:
    """The program's RecursiveProof as ints, lists and (x, y, inf) points."""
    def inst(u, relaxed=True):
        out = {"commit_w": plain(u.commit_w), "x": list(u.x)}
        if relaxed:
            out.update(commit_e=plain(u.commit_e), u=u.u)
        return out

    return {
        "i": proof.i,
        "z0_primary": list(proof.z0_primary), "z0_secondary": list(proof.z0_secondary),
        "zi_primary": list(proof.zi_primary), "zi_secondary": list(proof.zi_secondary),
        "u_single_secondary": inst(proof.u_single_secondary, relaxed=False),
        "w_single_secondary": list(proof.w_single_secondary.w),
        "u_range_primary": inst(proof.u_range_primary),
        "w_range_primary": {"w": list(proof.w_range_primary.w), "e": list(proof.w_range_primary.e)},
        "u_range_secondary": inst(proof.u_range_secondary),
        "w_range_secondary": {"w": list(proof.w_range_secondary.w), "e": list(proof.w_range_secondary.e)},
    }


class Driver:
    def __init__(self, config, traffic, seed, device):
        self.traffic, self.seed, self.device = traffic, seed, device
        self.work = None
        self.mode = None
        self.steps = 0

    def setup(self):
        pp = PublicParams.setup(ExampleFunction, ExampleFunction, KeyStream(self.seed), device=self.device)
        z0 = stream(self.seed, "z0")
        self.ivc = Ivc(pp, z0_primary=[z0.randrange(R)], z0_secondary=[z0.randrange(Q)])
        for w in range(self.traffic["warmup"]):
            self.request(-1 - w)

    def request(self, i: int):
        proof = self.ivc.prove_step()
        sync(self.device)
        self.steps += 1
        self.last = proof
        return proof.i

    def release(self):
        self.state = plain_state(self.last)
        self.ivc = self.last = None

    def check(self, answers):
        """One number: the decider's failed relations, summed over its four
        kinds (each printed on stderr)."""
        decider = ref.Decider()
        counts = decider.check(self.state, self.steps, decider.key_scalars(KeyStream(self.seed).rng))
        print("# decider: " + ", ".join(f"{k} {v}" for k, v in counts.items()), file=sys.stderr)
        total = sum(counts.values())
        return [("chain_failures", total, 0)], int(total > 0)

    def _control_commit(self):
        """The control's commit: the reference's opening in 240-bit scalars,
        returned as the program's point."""
        decider = ref.Decider()
        k1, k2 = decider.key_scalars(KeyStream(self.seed).rng)
        keys = {"G1": (G1, k1), "Grumpkin": (GRUMPKIN, k2)}

        def commit(ck, msg):
            curve, dlogs = keys[ck.spec.name]
            pt = ref.commit(curve, dlogs, list(msg), bits=CONTROL_BITS)
            if pt is None:
                return ck.spec.identity_affine()
            F = ck.spec.field
            return type(ck.spec.generator)(ck.spec, F(pt[0]), F(pt[1]), False)

        return commit

    def control(self):
        return patched(PedersenCommitment, "commit", self._control_commit())

    def fault(self, name):
        if name == "altered":
            real = PedersenCommitment.commit
            return patched(PedersenCommitment, "commit",
                           lambda ck, msg: real(ck, msg) + ck.spec.generator)
        if name == "unchanged":
            return patched(self.ivc, "prove_step", self.ivc._proof)
        raise KeyError(name)
