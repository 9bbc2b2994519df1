"""Sparse matrix-vector products over Fr or Fq words in plain PyTorch.

Counterpart of `kogarashi_tpu/ops/spmv.py` (`coo_matvec` :22,
`r1cs_matrices_device` :47, `matvec` :61, `transposed_matvec` :66). The
R1CS matrices are COO triples; a product gathers vector entries, runs one
batched Montgomery multiply, sums the 16-bit halves per segment with
`index_add_` in int64 (exact: a segment would need 2^46 entries to
overflow), and reduces each sum once, exactly (`Fp.reduce_wide`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..devices import resolve
from ..fields import mont
from ..fields.spec import FieldSpec


def coo_matvec(coeffs, gather_idx, seg_idx, vec, num_segments: int, spec: FieldSpec):
    """sum over entries e with seg_idx[e] = s of coeffs[e] * vec[gather_idx[e]].

    coeffs: (8, nnz) Montgomery words; vec: (8, ncols) Montgomery words;
    gather_idx, seg_idx: (nnz,) int64. Returns (8, num_segments) words."""
    F = mont.field(spec)
    prods = F.mul(mont.to_halves(coeffs), mont.to_halves(vec)[:, gather_idx])
    sums = torch.zeros((16, num_segments), dtype=torch.int64, device=vec.device)
    sums.index_add_(1, seg_idx, prods)
    return mont.to_words(F.reduce_wide(sums))


def _encode_coeffs(vals, spec: FieldSpec) -> np.ndarray:
    """Coefficients -> (8, nnz) Montgomery words. Repeated values (typical
    R1CS: mostly +-1) are encoded once and gathered."""
    if isinstance(vals, np.ndarray) and vals.dtype != object:
        uniq, inv = np.unique(vals, return_inverse=True)
        return spec.encode([int(u) for u in uniq])[:, inv.reshape(-1)]
    index: dict = {}
    inv = [index.setdefault(int(v), len(index)) for v in vals]
    return spec.encode(list(index))[:, np.asarray(inv, np.int64)]


def coo_matrix(ri, ci, vals, spec: FieldSpec, device) -> dict:
    """Row indices, column indices and coefficient ints -> a COO dict on
    `device`."""
    return dict(
        row=torch.from_numpy(np.asarray(ri, np.int64)).to(device),
        col=torch.from_numpy(np.asarray(ci, np.int64)).to(device),
        coeff=torch.from_numpy(np.ascontiguousarray(_encode_coeffs(vals, spec))).to(device),
    )


def r1cs_matrices(cs, spec: FieldSpec, device=None):
    """Host R1CS (anything with `matrices_coo()`) -> [A, B, C] COO dicts on
    `device` (None: the card)."""
    device = resolve(device)
    return [coo_matrix(ri, ci, vals, spec, device) for ri, ci, vals in cs.matrices_coo()]


def matvec(mat: dict, z, m: int, spec: FieldSpec):
    """A . z for a COO dict (row-indexed segments)."""
    return coo_matvec(mat["coeff"], mat["col"], mat["row"], z, m, spec)


def transposed_matvec(mat: dict, lag, n_wires: int, spec: FieldSpec):
    """Per-wire QAP evaluation: sum_i coeff * lag[row_i], grouped by wire."""
    return coo_matvec(mat["coeff"], mat["row"], mat["col"], lag, n_wires, spec)
