"""Prover (parity: groth16/src/prover.rs:20-99; counterpart of
`kogarashi_tpu/groth16/prover.py::Prover.create_proof` :78).

Device pipeline per proof, on the device the parameters live on:
SpMV Az/Bz/Cz -> idft + coset_dft of the three polynomials on one batch
axis -> pointwise A.B - C -> divide by Z on the coset -> coset_idft -> five
MSMs (h, l, a and b over G1, b over G2). Host: witness synthesis, r/s
blinding drawn from the caller's rng in the JAX package's order, and the
O(1) point algebra. A CUDA device runs the MSMs on the CUDA kernels, a CPU
device on their plain versions.
"""

from __future__ import annotations

import logging
import random

import torch

from .. import constants as C
from ..curves import G1, G2, decode_points
from ..errors import ProverSubVersionCrsAttack
from ..fields import mont
from ..fields.spec import FR, ints_to_words
from ..ops.msm import msm
from ..ops.ntt import Domain
from ..ops.spmv import matvec
from ..stages import Stages
from .keys import Parameters, Proof

LOG = logging.getLogger(__name__)


class Prover:
    def __init__(self, params: Parameters):
        self.params = params
        self.device = params.h[0].device
        self._dom = Domain(params.n.bit_length() - 1, device=self.device)

    def create_proof(self, circuit, rng: random.Random | None = None) -> Proof:
        rng = rng or random.Random()
        p = self.params
        dev = self.device
        r_mod = C.R
        st = Stages(LOG, "prove", dev)
        cs = circuit.build()
        dom = self._dom
        n, m = p.n, cs.m

        z_std_words = torch.from_numpy(ints_to_words(cs.z_ints())).to(dev)
        z_dev = mont.from_std(z_std_words, FR)
        z_std = mont.to_halves(z_std_words)  # the MSMs' standard-form 16-bit limbs
        w_std = z_std[:, len(cs.x):]
        st.mark("witness (host)")

        evals = torch.stack([
            torch.nn.functional.pad(matvec(mat, z_dev, m, FR), (0, n - m)) for mat in p.mats
        ], dim=1)  # (8, 3, n)

        on_coset = dom.coset_dft(dom.idft(evals))
        a_c, b_c, c_c = on_coset[:, 0], on_coset[:, 1], on_coset[:, 2]
        h = mont.sub(mont.mul(a_c, b_c, spec=FR), c_c, spec=FR)
        q = dom.coset_idft(dom.divide_by_z_on_coset(h))
        q_std = mont.to_halves(mont.to_std(q, FR))[:, : n - 1].contiguous()
        st.mark("H polynomial (SpMV, NTT)")

        def run_msm(name, curve, query, scal):
            pt = decode_points(curve, msm(curve, *query, scal))[0]
            st.mark(f"MSM {name}")
            return pt

        q_pt = run_msm("h (G1)", G1, p.h, q_std)
        l_pt = run_msm("l (G1)", G1, p.l, w_std)
        a_answer = run_msm("a (G1)", G1, p.a, z_std)
        b1_answer = run_msm("b (G1)", G1, p.b_g1, z_std)
        b2_answer = run_msm("b (G2)", G2, p.b_g2, z_std)

        vk = p.vk
        if vk.delta_g1.is_infinity or vk.delta_g2.is_infinity:
            raise ProverSubVersionCrsAttack("CRS delta is the identity")

        r = rng.randrange(r_mod)
        s = rng.randrange(r_mod)

        g_a = vk.delta_g1 * r + vk.alpha_g1 + a_answer
        g_b = vk.delta_g2 * s + vk.beta_g2 + b2_answer
        g_c = (
            vk.delta_g1 * (r * s % r_mod)
            + vk.alpha_g1 * s
            + vk.beta_g1 * r
            + a_answer * s
            + b1_answer * r
            + q_pt
            + l_pt
        )
        st.mark("proof assembly (host)")
        return Proof(a=g_a, b=g_b, c=g_c)
