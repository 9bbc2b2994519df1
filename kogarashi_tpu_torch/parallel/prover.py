"""The prover's H-polynomial pipeline on the distributed NTT.

Counterpart of `kogarashi_tpu/parallel/prover.py::distributed_h_coeffs`
(:21): idft -> coset_dft -> A.B - C -> /Z -> coset_idft, every transform a
`DistributedDomain` 4-step NTT and the elementwise algebra on the rank's
shard. A, B and C travel as one batch, so the pipeline makes three
all-to-alls (idft, coset_dft, coset_idft) and one all_gather; the JAX
function transforms them one by one, seven all-to-alls.
"""

from __future__ import annotations

import torch

from ..fields import mont
from .ntt import DistributedDomain


def distributed_h_coeffs(dd: DistributedDomain, az, bz, cz):
    """az, bz, cz: flat (8, n) natural-order evaluations of A.z, B.z, C.z on
    the domain (the whole vectors, on the rank's device) -> flat (8, n)
    coefficients of H = (A.B - C) / Z, on every rank. The value of the
    single-device pipeline in `groth16/prover.py`."""
    on_coset = dd.coset_dft(dd.idft(dd.scatter_evals(torch.stack([az, bz, cz], dim=1))))
    a, b, c = on_coset.unbind(1)
    h = mont.sub(mont.mul(a, b, spec=dd.spec), c, spec=dd.spec)
    return dd.gathered_coeffs(dd.coset_idft(dd.divide_by_z_on_coset(h)))
