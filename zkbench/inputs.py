"""Inputs from `--seed`: independent streams by label, and uniform field
elements made on the device.

Every input a cell draws comes from `stream(seed, label, ...)` or
`uniform_limbs(...)`, so the same seed gives the same inputs and two labels
never share a stream. Field elements are (16, n) int32 standard-form 16-bit
limbs, little-endian, the form the port's MSM and fixed-base kernels take.
"""

from __future__ import annotations

import hashlib
import random

import numpy as np
import torch

# BN254's scalar field (Fr) and base field (Fq): the group orders of G1 and of
# Grumpkin, frozen here so that the inputs do not depend on the program.
R = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001
Q = 0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47


def derive(seed: int, *label) -> int:
    """A 128-bit integer that depends on `seed` and `label` alone."""
    text = ":".join(str(v) for v in (seed, *label)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:16], "little")


def stream(seed: int, *label) -> random.Random:
    """A host random stream for `label` under `seed`."""
    return random.Random(derive(seed, *label))


def uniform_limbs(seed: int, label: str, n: int, modulus: int, device, nonzero: bool = False):
    """(16, n) int32 limbs of n integers uniform in [0, modulus) (or
    [1, modulus)), drawn by a torch.Generator on `device` and rejection:
    columns at or above the modulus are drawn again."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, label) & ((1 << 63) - 1))
    top_bits = modulus.bit_length() - 15 * 16
    mod = torch.tensor([(modulus >> (16 * i)) & 0xFFFF for i in range(16)], dtype=torch.int32,
                       device=device)[:, None]
    out = torch.empty((16, n), dtype=torch.int32, device=device)
    todo = torch.arange(n, device=device)
    while todo.numel():
        k = todo.numel()
        cand = torch.randint(0, 1 << 16, (16, k), generator=gen, device=device, dtype=torch.int32)
        cand[15] &= (1 << top_bits) - 1
        below = torch.zeros(k, dtype=torch.bool, device=device)
        equal = torch.ones(k, dtype=torch.bool, device=device)
        for limb in range(15, -1, -1):
            below |= equal & (cand[limb] < mod[limb])
            equal &= cand[limb] == mod[limb]
        ok = below & (cand.any(dim=0) if nonzero else True)
        out[:, todo[ok]] = cand[:, ok]
        todo = todo[~ok]
    return out


def limbs_to_ints(limbs) -> list[int]:
    """(16, n) 16-bit limbs (a tensor or array) -> Python ints."""
    a = np.ascontiguousarray(np.asarray(limbs.cpu() if torch.is_tensor(limbs) else limbs)
                             .astype(np.uint16).T)
    buf = a.tobytes()
    return [int.from_bytes(buf[i : i + 32], "little") for i in range(0, len(buf), 32)]

