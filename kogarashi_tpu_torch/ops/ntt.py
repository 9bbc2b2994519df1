"""Radix-2 NTT over Fr in plain PyTorch.

Counterpart of `kogarashi_tpu/ops/ntt.py::Domain` (:39), with the same
semantics (reference: groth16/src/fft.rs): bit-reverse the input, then
decimation-in-time butterflies with twiddles g^j, giving natural-order
evaluations eval[i] = f(w^i); `idft` uses inverse twiddles and scales by
n^-1; the coset transforms pre/post-multiply by powers of the
multiplicative generator; `divide_by_z_on_coset` scales by (g^n - 1)^-1.

Transforms act on word tensors shaped (8, ..., n), evaluation axis last.
Each butterfly stage is one batched Montgomery multiply plus an add and a
subtract over the whole array.
"""

from __future__ import annotations

import numpy as np
import torch

from ..devices import resolve
from ..fields import mont
from ..fields.spec import FR, FieldSpec, ints_to_words


def _bit_reverse_perm(k: int) -> np.ndarray:
    idx = np.arange(1 << k)
    rev = np.zeros(1 << k, dtype=np.int64)
    for b in range(k):
        rev |= ((idx >> b) & 1) << (k - 1 - b)
    return rev


def _powers(base: int, count: int, p: int) -> list[int]:
    out, acc = [], 1
    for _ in range(count):
        out.append(acc)
        acc = acc * base % p
    return out


class Domain:
    """2^k-point NTT domain over `spec` (default Fr); tables live on `device`
    (None: the card)."""

    def __init__(self, k: int, spec: FieldSpec = FR, device=None):
        assert 1 <= k <= spec.s
        device = resolve(device)
        self.k = k
        self.n = n = 1 << k
        self.F = mont.field(spec)
        p = spec.p
        g = pow(spec.root_of_unity, 1 << (spec.s - k), p)
        mul_g = spec.generator

        def table(vals):  # standard-form ints -> Montgomery halves (16, len)
            return self.F.from_std(mont.to_halves(torch.from_numpy(ints_to_words(vals)).to(device)))

        self.twiddles = table(_powers(g, n // 2, p))
        self.inv_twiddles = table(_powers(pow(g, -1, p), n // 2, p))
        self.cosets = table(_powers(mul_g, n, p))
        self.inv_cosets = table(_powers(pow(mul_g, -1, p), n, p))
        self.n_inv = pow(n, -1, p)
        self.z_coset_inv = pow(pow(mul_g, n, p) - 1, -1, p)
        self.perm = torch.from_numpy(_bit_reverse_perm(k)).to(device)

    def _fft(self, x, twiddles):
        """(16, ..., n) halves -> (16, ..., n) halves."""
        n, F = self.n, self.F
        assert x.shape[-1] == n
        x = x[..., self.perm]
        shape = x.shape
        m = 1
        while m < n:
            tw = twiddles[:, :: n // (2 * m)][:, :m]
            tw = tw.reshape((16,) + (1,) * (x.ndim - 1) + (m,))
            xr = x.reshape(*shape[:-1], n // (2 * m), 2, m)
            u = xr[..., 0, :]
            v = F.mul(xr[..., 1, :], tw)
            x = torch.stack([F.add(u, v), F.sub(u, v)], dim=-2).reshape(shape)
            m *= 2
        return x

    def _scale(self, h, v: int):
        return self.F.mul(h, self.F.const(v, (1,) * (h.ndim - 1), h.device))

    def _table(self, h, table):
        return self.F.mul(h, table.reshape((16,) + (1,) * (h.ndim - 2) + (self.n,)))

    def dft(self, coeffs):
        """Coefficients -> natural-order evaluations at w^i (words)."""
        return mont.to_words(self._fft(mont.to_halves(coeffs), self.twiddles))

    def idft(self, evals):
        """Evaluations -> coefficients, scaled by n^-1 (words)."""
        out = self._fft(mont.to_halves(evals), self.inv_twiddles)
        return mont.to_words(self._scale(out, self.n_inv))

    def coset_dft(self, coeffs):
        """Evaluate on the coset g*w^i (multiply coeff_i by g^i first)."""
        h = self._table(mont.to_halves(coeffs), self.cosets)
        return mont.to_words(self._fft(h, self.twiddles))

    def coset_idft(self, evals):
        """Inverse of coset_dft."""
        out = self._scale(self._fft(mont.to_halves(evals), self.inv_twiddles), self.n_inv)
        return mont.to_words(self._table(out, self.inv_cosets))

    def divide_by_z_on_coset(self, evals):
        """Divide coset evaluations by Z(g*w^i) = g^n - 1 (constant on the coset)."""
        return mont.to_words(self._scale(mont.to_halves(evals), self.z_coset_inv))
