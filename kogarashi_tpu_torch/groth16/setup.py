"""Trusted setup (parity: groth16/src/zksnark.rs:17-127; counterpart of
`kogarashi_tpu/groth16/setup.py::setup` :53).

  host:   synthesize the circuit, draw the toxic waste (alpha, beta, gamma,
          delta, tau in that order, as the JAX package does), powers of tau;
  device: fixed-base h query [(tau^i t(tau) / delta)] G1, Lagrange
          coefficients (idft of the tau powers), per-wire QAP evaluations
          (transposed SpMV), ext = (beta u + alpha v + w) / {gamma, delta},
          fixed-base A / B_G1 / B_G2 / ic / l queries, batched to affine;
  host:   the verifying-key points.

The queries come out as affine words (x, y, inf), the MSM's input, so no
conversion step follows. As in the JAX package, the h query has n - 1
entries (n = FFT domain size).
"""

from __future__ import annotations

import logging
import random

import torch

from .. import constants as C
from ..curves import G1, G2, decode_affine, to_affine
from ..devices import resolve
from ..fields import mont
from ..fields.spec import FR, ints_to_limbs16, ints_to_words
from ..ops.fixed_base import fixed_base_mul
from ..ops.ntt import Domain
from ..ops.spmv import r1cs_matrices, transposed_matvec
from ..pyref import G1_SPEC, G2_SPEC
from ..stages import Stages
from .keys import Parameters, Verifier, VerifyingKey
from .prover import Prover

LOG = logging.getLogger(__name__)


def fr_words(vals, device):
    """Standard-form ints -> (8, n) Montgomery Fr words on `device`."""
    return mont.from_std(torch.from_numpy(ints_to_words(vals)).to(device), FR)


def std_limbs(words):
    """(8, n) Montgomery Fr words -> (16, n) standard-form 16-bit limbs."""
    return mont.to_halves(mont.to_std(words, FR))


def setup(circuit, rng: random.Random | None = None, device=None):
    """Returns (Prover, Verifier); the parameters live on `device` (None:
    the card, which must exist; "cpu" runs the kernels' plain versions)."""
    device = resolve(device)
    rng = rng or random.Random()
    r = C.R
    st = Stages(LOG, "setup", device)
    cs = circuit.build()
    m = cs.m
    n = 1 << (m - 1).bit_length() if m > 1 else 2
    dom = Domain(n.bit_length() - 1, device=device)

    alpha, beta, gamma, delta, tau = (rng.randrange(1, r) for _ in range(5))
    gamma_inv = pow(gamma, -1, r)
    delta_inv = pow(delta, -1, r)

    powers = [1] * n
    for i in range(1, n):
        powers[i] = powers[i - 1] * tau % r

    coeff = (pow(tau, n, r) - 1) * delta_inv % r
    h_scalars = [p * coeff % r for p in powers[: n - 1]]
    st.mark("synthesis, toxic waste, powers of tau (host)")
    h_query = fixed_base_mul(G1, torch.from_numpy(ints_to_limbs16(h_scalars)).to(device))

    st.mark("h query (fixed base)")
    lag = dom.idft(fr_words(powers, device))

    l_pub = cs.l()
    num_wires = l_pub + cs.m_l_1()
    mats = r1cs_matrices(cs, FR, device)
    at, bt, ct = (transposed_matvec(mat, lag, num_wires, FR) for mat in mats)

    F = mont.field(FR)
    inv_vec = torch.cat([
        F.const(gamma_inv, (l_pub,), device), F.const(delta_inv, (cs.m_l_1(),), device)
    ], dim=1)
    ah, bh, ch = (mont.to_halves(t) for t in (at, bt, ct))
    beta_c, alpha_c = F.const(beta, (1,), device), F.const(alpha, (1,), device)
    ext = mont.to_words(F.mul(F.add(F.add(F.mul(ah, beta_c), F.mul(bh, alpha_c)), ch), inv_vec))

    st.mark("Lagrange coefficients, QAP evaluations (NTT, SpMV)")
    at_std, bt_std, ext_std = std_limbs(at), std_limbs(bt), std_limbs(ext)
    a_query = fixed_base_mul(G1, at_std)
    b_g1_query = fixed_base_mul(G1, bt_std)
    b_g2_query = fixed_base_mul(G2, bt_std)
    ic_query = fixed_base_mul(G1, ext_std[:, :l_pub].contiguous())
    l_query = fixed_base_mul(G1, ext_std[:, l_pub:].contiguous())
    st.mark("a, b_g1, b_g2, ic, l queries (fixed base)")

    g1, g2 = G1_SPEC.generator, G2_SPEC.generator
    vk = VerifyingKey(
        alpha_g1=alpha * g1,
        beta_g1=beta * g1,
        beta_g2=beta * g2,
        gamma_g2=gamma * g2,
        delta_g1=delta * g1,
        delta_g2=delta * g2,
        ic=decode_affine(G1, *to_affine(G1, ic_query)),
    )
    params = Parameters(
        vk=vk,
        h=to_affine(G1, h_query),
        l=to_affine(G1, l_query),
        a=to_affine(G1, a_query),
        b_g1=to_affine(G1, b_g1_query),
        b_g2=to_affine(G2, b_g2_query),
        l_pub=l_pub,
        n=n,
        mats=mats,
        num_wires=num_wires,
    )
    st.mark("queries to affine, verifying key")
    return Prover(params), Verifier(vk.prepare())
