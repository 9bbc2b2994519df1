"""Where the port's entry points put their tensors.

The public entry points (`groth16.setup`, `interop.*`, `curves.prepare_points`
and `encode_projective`, `FixedBaseTable`, `ntt.Domain`,
`spmv.r1cs_matrices`) take `device=None`, which means the card. The CPU,
where the kernels' plain versions run, is used only when a caller asks for
it with `device="cpu"`. Internal helpers follow their input tensors.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """None -> torch.device("cuda"), which must exist; else `device` as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the port runs on the card by default; "
                               "pass device='cpu' to run the plain versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)
