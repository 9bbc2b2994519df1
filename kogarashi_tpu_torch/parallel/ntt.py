"""Distributed radix-2 NTT by the 4-step (Bailey) decomposition.

Counterpart of `kogarashi_tpu/parallel/ntt.py::DistributedDomain` (:32).
N = N1 * N2, k1 = k // 2, k2 = k - k1, with the same global layouts in the
port's words:
  * coefficients (8, n1, n2), flat index n1_idx * N2 + n2_idx, n2 sharded;
  * evaluations (8, k2, k1) (the transposed layout), flat index
    k2 * N1 + k1 = the natural order, k1 sharded.
`dft`: a local DFT_N1 over each owned column, the twiddle w^(k1 n2), one
all-to-all that moves the shard from n2 to k1, a local DFT_N2 over each
owned row. `idft` mirrors it. Every method takes and returns this rank's
shard (the view JAX's `shard_map` body sees); `scatter_*` cut it out of a
whole array and `gathered*` all_gather it back into the flat natural order.
Any leading axes between the word axis and the two domain axes are a batch
(the H pipeline carries A, B and C together).

The local DFTs are the port's `ops/ntt.py::Domain` over the last axis
(N1 on the card, its plain version on the CPU). Each rank builds only its own columns of
the twiddle and coset tables, on its device, by repeated doubling with the
field engine; the JAX package builds each whole table in a Python loop over
2^k ints (:51-93).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..fields import mont
from ..fields.spec import FR, FieldSpec
from ..ops.ntt import Domain
from .msm import all_gather_stack, make_mesh, mesh_axis, mesh_device


def _geometric(F, start, ratio, count: int):
    """start * ratio^i for i < count (a power of two), on a new axis 1:
    (16, m) halves -> (16, count, m), by doubling."""
    out, r = start.unsqueeze(1), ratio.unsqueeze(1)
    while out.shape[1] < count:
        out = torch.cat([out, F.mul(out, r)], dim=1)
        r = F.sqr(r)
    return out[:, :count]


class DistributedDomain:
    """2^k-point NTT over `spec` with N2 sharded over `axis` of `mesh`
    (default: every rank on one axis), on `device` (default: the mesh's).
    Raises ValueError unless D^2 divides 2^k and D divides N1 and N2."""

    def __init__(self, k: int, mesh=None, axis: str = "shard", spec: FieldSpec = FR, device=None):
        self.mesh = make_mesh() if mesh is None else mesh
        self.axis, self.spec = axis, spec
        self.group, self.nd, self.index = mesh_axis(self.mesh, axis)
        self.device = dev = mesh_device(self.mesh, device)
        nd = self.nd
        self.k, self.n = k, 1 << k
        if self.n % (nd * nd):
            raise ValueError(f"need N = 2^{k} divisible by D^2 = {nd * nd}")
        self.k1 = k // 2
        self.k2 = k - self.k1
        self.n1, self.n2 = 1 << self.k1, 1 << self.k2
        if self.n1 % nd or self.n2 % nd:
            raise ValueError(f"need N1 = {self.n1} and N2 = {self.n2} divisible by D = {nd}")
        self.dom1 = Domain(self.k1, spec, dev)
        self.dom2 = Domain(self.k2, spec, dev)
        F = mont.field(spec)
        p = spec.p
        w = pow(spec.root_of_unity, 1 << (spec.s - k), p)  # 2^k-th root
        g = spec.generator
        m, c0 = self.n2 // nd, self.index * (self.n2 // nd)  # this rank's columns c0 .. c0 + m - 1

        def const(v):
            return F.const(v, (1,), dev)

        def words(h):
            return mont.to_words(h.contiguous())

        def twiddle(root):  # T[k1, c] = root^(k1 c), (8, n1, m)
            cols = _geometric(F, const(pow(root, c0, p)), const(root), m)[:, :, 0]
            return words(_geometric(F, F.one((m,), dev), cols, self.n1))

        def coset(gen):  # gen^(n1_idx N2 + c), (8, n1, m)
            cols = _geometric(F, const(pow(gen, c0, p)), const(gen), m)[:, :, 0]
            return words(_geometric(F, cols, const(pow(gen, self.n2, p)).expand(-1, m), self.n1))

        self.twiddle = twiddle(w)
        self.inv_twiddle = twiddle(pow(w, -1, p))
        self.coset_table = coset(g)
        self.inv_coset_table = coset(pow(g, -1, p))
        self.z_coset_inv = pow(pow(g, self.n, p) - 1, -1, p)

    # -- helpers -----------------------------------------------------------

    def _exchange(self, a):
        """(8, *batch, R, D m) -> (8, *batch, D R, m): block d of the last
        axis goes to rank d, and the blocks received from ranks 0 .. D - 1
        line up on the second-last axis in rank order. JAX's
        all_to_all(split_axis=last, concat_axis=second-last, tiled=False)
        on the split (8, *batch, R, D, m) (:119, :152), as one
        all_to_all_single over the D blocks moved to the front."""
        nd = self.nd
        *lead, r, L = a.shape
        blocks = a.reshape(*lead, r, nd, L // nd).movedim(-2, 0).contiguous()  # (D, 8, *batch, R, m)
        got = torch.empty_like(blocks)
        dist.all_to_all_single(got, blocks, group=self.group)
        return got.movedim(0, -3).reshape(*lead, nd * r, L // nd)

    def _gather_flat(self, out):
        """(8, *batch, a, b) shards, b sharded -> (8, *batch, a * D * b)."""
        every = all_gather_stack(out, self.group, self.nd)  # (D, 8, *batch, a, b)
        return every.movedim(0, -2).reshape(*out.shape[:-2], -1)

    # -- transforms (:96-204) ---------------------------------------------

    def dft(self, x):
        """(8, *batch, n1, n2/D) coefficient shard -> (8, *batch, n2, n1/D)
        transposed evaluation shard (:96)."""
        a = self.dom1.dft(x.transpose(-1, -2))  # (8, *batch, n2/D, n1)
        a = self._coset_mul(a, self.twiddle.transpose(-1, -2))
        a = self._exchange(a)  # (8, *batch, n2, n1/D)
        return self.dom2.dft(a.transpose(-1, -2)).transpose(-1, -2).contiguous()

    def idft(self, x):
        """Exact mirror of `dft` (:129): (8, *batch, n2, n1/D) evaluation
        shard -> (8, *batch, n1, n2/D) coefficient shard, scaled by 1/N
        (dom2's 1/N2 times dom1's 1/N1)."""
        a = self.dom2.idft(x.transpose(-1, -2))  # (8, *batch, n1/D, n2)
        a = self._exchange(a)  # (8, *batch, n1, n2/D)
        a = self._coset_mul(a, self.inv_twiddle)
        return self.dom1.idft(a.transpose(-1, -2)).transpose(-1, -2).contiguous()

    def coset_dft(self, coeffs):
        """Evaluate on the coset g w^i: coeff_i *= g^i first (:164)."""
        return self.dft(self._coset_mul(coeffs, self.coset_table))

    def coset_idft(self, evals):
        """Inverse of coset_dft: idft, then divide by g^i (:169)."""
        return self._coset_mul(self.idft(evals), self.inv_coset_table)

    def divide_by_z_on_coset(self, evals):
        """Divide coset evaluations by Z(g w^i) = g^n - 1, a constant (:173)."""
        F = mont.field(self.spec)
        h = mont.to_halves(evals)
        return mont.to_words(F.mul(h, F.const(self.z_coset_inv, (1,) * (h.ndim - 1), h.device)))

    def _coset_mul(self, x, table):
        """x (8, *batch, a, b) times an (8, a, b) table, elementwise (:191;
        `dft` and `idft` take their twiddles this way too)."""
        t = table.reshape(table.shape[:1] + (1,) * (x.ndim - table.ndim) + table.shape[1:])
        return mont.mul(x, t, spec=self.spec)

    # -- layouts (:206-233) -----------------------------------------------

    def scatter_evals(self, evals):
        """(8, *batch, n) natural-order evaluations -> this rank's shard of
        the (8, *batch, k2, k1) layout `idft` takes."""
        m = self.n1 // self.nd
        a = evals.reshape(*evals.shape[:-1], self.n2, self.n1)
        return a[..., self.index * m : (self.index + 1) * m].contiguous()

    def gathered_coeffs(self, out):
        """(8, *batch, n1, n2/D) coefficient shards -> flat (8, *batch, n)
        natural order on every rank (undoes scatter_input)."""
        return self._gather_flat(out)

    def scatter_input(self, coeffs):
        """(8, *batch, n) flat coefficients -> this rank's shard of the
        (8, *batch, n1, n2) input layout (index n1_idx * N2 + n2_idx)."""
        m = self.n2 // self.nd
        a = coeffs.reshape(*coeffs.shape[:-1], self.n1, self.n2)
        return a[..., self.index * m : (self.index + 1) * m].contiguous()

    def gathered(self, out):
        """(8, *batch, k2, k1/D) transposed output shards -> flat natural
        order (8, *batch, n), X[k1 + N1 k2], on every rank."""
        return self._gather_flat(out)

    def flat_index(self):
        """Flat natural-order index k -> its position in the flattened
        (k2, k1) output layout."""
        k = np.arange(self.n)
        k1 = k % self.n1
        k2 = k // self.n1
        return k2 * self.n1 + k1
