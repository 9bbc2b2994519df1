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


def synchronize(device) -> None:
    """Wait for the work queued on `device` (a no-op on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def backend_name(device) -> str:
    """The card's name (`torch.cuda.get_device_name`), or "cpu"."""
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def describe(device) -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` prints them, or "cpu"."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    import subprocess

    lines = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return lines[device.index or 0]
