"""G1 MSMs over 2^constraints_log2 distinct bases, one after another.

Set-up, all on the device: the bases' discrete logs k_i uniform in [1, r)
from the seed, the bases k_i G by the port's fixed-base multiplication and
`to_affine`, and a pool of `scalar_pool` scalar sets uniform in [0, r);
then `warmup` MSMs. A request is `ops.msm.msm` on G1 with the next set of
the pool, the result copied to the host and made affine there. Its nominal
work is n * ceil(256 / NOMINAL_WINDOW_BITS) point-adds, whatever window the
program picks. The reference is sum_i s_i k_i times the generator, once per
set of the pool; the check holds every MSM of the window to it.
"""

from __future__ import annotations

import contextlib
import math

import torch

from kogarashi_tpu_torch.curves import G1, decode_points, to_affine
from kogarashi_tpu_torch.ops import msm as msm_mod
from kogarashi_tpu_torch.ops.fixed_base import fixed_base_mul

from ..inputs import R, limbs_to_ints, uniform_limbs
from ..reference.msm import msm_by_dlogs
from ..roofline import g1_msm_bytes
from .common import CONTROL_BITS, affine, patched, plain

# The yardstick's window: a request's nominal work counts 16-bit windows of a
# 256-bit scalar, fixed here and not by the traffic mix or the program.
NOMINAL_WINDOW_BITS = 16


class Driver:
    def __init__(self, config, traffic, seed, device):
        self.n = 1 << config["constraints_log2"]
        self.traffic, self.seed, self.device = traffic, seed, torch.device(device)
        self.work = self.n * math.ceil(256 / NOMINAL_WINDOW_BITS)
        self.io_bytes = g1_msm_bytes(self.n)
        self.pool_size = traffic["scalar_pool"]
        self.mode = None

    def _dlogs(self):
        return uniform_limbs(self.seed, "bases", self.n, R, self.device, nonzero=True)

    def _scalars(self, j: int):
        return uniform_limbs(self.seed, f"scalars.{j}", self.n, R, self.device)

    def setup(self):
        self.x, self.y, self.inf = to_affine(G1, fixed_base_mul(G1, self._dlogs()))
        self.pool = [self._scalars(j) for j in range(self.pool_size)]
        if self.mode == "control":
            self.expected = [(pt or (0, 1)) + (pt is None,) for pt in self._reference(bits=CONTROL_BITS)]
        for w in range(self.traffic["warmup"]):
            self.request(w)

    def request(self, i: int):
        j = i % self.pool_size
        if self.mode == "control":
            return j, self.expected[j]
        out = msm_mod.msm(G1, self.x, self.y, self.inf, self.pool[j])
        pt = decode_points(G1, [o.cpu() for o in out])[0]
        if self.mode == "altered":
            pt = pt + G1.pyref_spec.generator
        return j, plain(pt)

    def release(self):
        self.x = self.y = self.inf = self.pool = None

    def _reference(self, bits=None):
        """The pool's MSMs as affine tuples (None: identity)."""
        k = limbs_to_ints(self._dlogs())
        return [msm_by_dlogs(limbs_to_ints(self._scalars(j)), k, bits=bits)
                for j in range(self.pool_size)]

    def check(self, answers):
        expected = self._reference()
        wrong = sum(affine(pt) != expected[j] for j, pt in answers)
        return [("msms_wrong", wrong, 0)], wrong

    def control(self):
        self.mode = "control"
        return contextlib.nullcontext()

    def fault(self, name):
        if name == "altered":
            self.mode = "altered"
            return contextlib.nullcontext()
        if name == "half":
            real = msm_mod.msm
            h = self.n // 2

            def half_msm(curve, x, y, inf, scalars, c=None):
                return real(curve, x[:, :h], y[:, :h], inf[:h], scalars[:, :h], c)

            return patched(msm_mod, "msm", half_msm)
        raise KeyError(name)
