"""Radix-2 NTT over Fr: the N1 kernel (`csrc/ntt.cu`) and its plain PyTorch version.

Counterpart of `kogarashi_tpu/ops/ntt.py::Domain` (:39), with the same
semantics (reference: groth16/src/fft.rs): bit-reverse the input, then
decimation-in-time butterflies with twiddles g^j, giving natural-order
evaluations eval[i] = f(w^i); `idft` uses inverse twiddles and scales by
n^-1; the coset transforms pre/post-multiply by powers of the
multiplicative generator; `divide_by_z_on_coset` scales by (g^n - 1)^-1.

Transforms act on word tensors shaped (8, ..., n), evaluation axis last;
the leading axes after the word axis are a batch of independent transforms.

Dispatch: an Fr Domain built on the card launches N1 for a CUDA tensor (a
few fused shared-memory passes, `pass_plan`; the scalings fused into them)
and counts each launch in `LAUNCHES` under its method; any other spec on a
CUDA tensor raises. A CPU tensor runs the plain version (`plain`): each
butterfly stage one batched Montgomery multiply plus an add and a subtract
over the whole array. There is no fallback from one to the other.
"""

from __future__ import annotations

import numpy as np
import torch

from ..devices import resolve
from ..fields import mont
from ..fields.spec import FR, FieldSpec, ints_to_words
from . import _build, ec

METHODS = ("dft", "idft", "coset_dft", "coset_idft", "divide_by_z_on_coset")
LAUNCHES: dict = {m: 0 for m in METHODS}

# csrc/ntt.cu kNttTileLog: a block's tile is at most 2^TILE_LOG elements of
# 8 words, SMEM_BYTES of dynamic shared memory
TILE_LOG = 11
SMEM_BYTES = 32 << TILE_LOG


def reset_launches() -> None:
    for m in LAUNCHES:
        LAUNCHES[m] = 0


def pass_plan(k: int, tile_log: int = TILE_LOG) -> tuple:
    """N1's passes for a 2^k transform: ((lo, m, log_j), ...), each pass
    stages [lo, lo + m) on tiles of 2^log_j sub-transforms of 2^m elements.
    As few passes as tiles of 2^tile_log allow, their stages split as evenly
    as they go, the larger first; J = 2^log_j fills the tile, within the
    transform (first pass) or within the 2^lo columns (later passes)."""
    n_pass = -(-k // tile_log)
    base, extra = divmod(k, n_pass)
    plan, lo = [], 0
    for i in range(n_pass):
        m = base + (i < extra)
        log_j = min(tile_log - m, k - m, lo if lo else k)
        plan.append((lo, m, log_j))
        lo += m
    return tuple(plan)


def bound_ms(method: str, rows: int, k: int, sm_clock_hz: float):
    """(ms, "operations" | "bytes"): the least time the card could take for
    one N1 call on `rows` transforms of 2^k: the larger of its Montgomery
    multiplies (k 2^(k-1) butterflies a transform, plus 2^k for each
    scaling; `ec.MULADD_PER_MUL` multiply-adds each at 64 per SM per clock on
    132 SMs) and reading the input, the tables and writing the output once
    at 3.35 TB/s."""
    n = 1 << k
    if method == "divide_by_z_on_coset":
        muls, table = rows * n, 1
    else:
        muls = rows * (k * n // 2 + (n if method != "dft" else 0))
        table = n // 2 + (n if method.startswith("coset") else 0)
    t_ops = muls * ec.MULADD_PER_MUL / (ec.H100_SMS * ec.MULADD_PER_SM_CLOCK * sm_clock_hz) * 1e3
    t_bytes = (2 * rows * n + table) * 32 / ec.H100_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


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


def _element_major(h):
    """(16, count) Montgomery halves -> (count, 8) int32 words, one element
    per 32 contiguous bytes (N1's tables)."""
    return mont.to_words(h).t().contiguous()


def _scaling(table):
    """(pointer, step) of a scaling table for kt_ntt_pass_fr: a table of one
    element is a constant (step 0); None scales nothing."""
    return (None, 0) if table is None else (table.data_ptr(), int(len(table) > 1))


class Domain:
    """2^k-point NTT domain over `spec` (default Fr); tables live on `device`
    (None: the card)."""

    def __init__(self, k: int, spec: FieldSpec = FR, device=None):
        assert 1 <= k <= spec.s
        device = resolve(device)
        self.k = k
        self.n = n = 1 << k
        self.spec = spec
        self.F = F = mont.field(spec)
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
        # N1's tables (Fr on the card): twiddles, the scalings it fuses
        self.kernel_tables = None
        if device.type == "cuda" and spec.name == FR.name:
            n_inv = F.const(self.n_inv, (1,), device)
            self.kernel_tables = {
                "tw": _element_major(self.twiddles),
                "inv_tw": _element_major(self.inv_twiddles),
                "cosets": _element_major(self.cosets),
                "inv_cosets_n_inv": _element_major(F.mul(self.inv_cosets, n_inv)),
                "n_inv": _element_major(n_inv),
                "z_coset_inv": _element_major(F.const(self.z_coset_inv, (1,), device)),
            }

    # -- the public transforms: N1 for a CUDA tensor, the plain version for a CPU one

    def dft(self, coeffs):
        """Coefficients -> natural-order evaluations at w^i (words)."""
        return self._run("dft", coeffs)

    def idft(self, evals):
        """Evaluations -> coefficients, scaled by n^-1 (words)."""
        return self._run("idft", evals)

    def coset_dft(self, coeffs):
        """Evaluate on the coset g*w^i (multiply coeff_i by g^i first)."""
        return self._run("coset_dft", coeffs)

    def coset_idft(self, evals):
        """Inverse of coset_dft."""
        return self._run("coset_idft", evals)

    def divide_by_z_on_coset(self, evals):
        """Divide coset evaluations by Z(g*w^i) = g^n - 1 (constant on the coset)."""
        return self._run("divide_by_z_on_coset", evals)

    def _run(self, method: str, x):
        if x.device.type == "cuda":
            return self._launch(method, x)
        if x.device.type != "cpu":
            raise ValueError(f"unsupported device {x.device}")
        return self.plain(method, x)

    # -- N1 (csrc/ntt.cu)

    # method -> (twiddle table, table scaled in at the first pass's load, at
    # the last pass's store); a table of one element is a constant
    _PASSES = {
        "dft": ("tw", None, None),
        "idft": ("inv_tw", None, "n_inv"),
        "coset_dft": ("tw", "cosets", None),
        "coset_idft": ("inv_tw", None, "inv_cosets_n_inv"),
    }

    def _launch(self, method: str, x):
        tables = self.kernel_tables
        if tables is None:
            raise ValueError(f"ops/ntt.py: N1 runs Fr on a Domain built on the card; this one is "
                             f"{self.spec.name} on {self.perm.device}")
        if x.dtype != torch.int32 or x.ndim < 2 or x.shape[0] != 8 or x.shape[-1] != self.n:
            raise ValueError(f"ops/ntt.py: expected (8, ..., {self.n}) int32 words, got {x.dtype} {tuple(x.shape)}")
        if x.device != tables["tw"].device:
            raise ValueError(f"ops/ntt.py: words on {x.device}, the Domain's tables on {tables['tw'].device}")
        x = x.contiguous()
        out = torch.empty_like(x)
        rows = x.numel() // (8 * self.n)
        if rows == 0:
            return out
        lib = _build.lib()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            if method == "divide_by_z_on_coset":
                rc = lib.kt_ntt_scale_fr(x.data_ptr(), out.data_ptr(), tables["z_coset_inv"].data_ptr(),
                                         rows * self.n, stream)
                _build.check(rc, "ntt_scale")
                LAUNCHES[method] += 1
                return out
            tw, pre, post = (tables.get(t) for t in self._PASSES[method])
            plan = pass_plan(self.k)
            for i, (lo, m, log_j) in enumerate(plan):
                rc = lib.kt_ntt_pass_fr(x.data_ptr(), out.data_ptr(), tw.data_ptr(),
                                        *_scaling(pre if i == 0 else None),
                                        *_scaling(post if i == len(plan) - 1 else None),
                                        rows, self.k, lo, m, log_j, stream)
                _build.check(rc, "ntt_pass")
                LAUNCHES[method] += 1
        return out

    # -- the plain version, on any device (the CPU path; the card's yardstick)

    def plain(self, method: str, x):
        """`method`'s plain PyTorch version on x's device."""
        h = mont.to_halves(x)
        if method == "dft":
            out = self._fft(h, self.twiddles)
        elif method == "idft":
            out = self._scale(self._fft(h, self.inv_twiddles), self.n_inv)
        elif method == "coset_dft":
            out = self._fft(self._table(h, self.cosets), self.twiddles)
        elif method == "coset_idft":
            out = self._table(self._scale(self._fft(h, self.inv_twiddles), self.n_inv), self.inv_cosets)
        elif method == "divide_by_z_on_coset":
            out = self._scale(h, self.z_coset_inv)
        else:
            raise ValueError(f"unknown method {method}")
        return mont.to_words(out)

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
