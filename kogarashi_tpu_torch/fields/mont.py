"""Plain-PyTorch Montgomery arithmetic over the port's word layout.

Public functions take and return int32 word tensors shaped (W * ext, ...),
W = the spec's `n_words` (8; 12 for BLS12-381's base field), see `spec`.
Internally the math runs on 16-bit halves held in int64, shaped
(2W * ext, ...), because torch's uint32 supports few ops: a 16x16-bit
product is exact in int64 and lazy row sums stay far below 2^63. The
descriptions below give the 8-word sizes.

Every op returns a canonical value in [0, p):
  * `mul` is CIOS over 16 halves (products accumulated unsplit in int64
    rows, one carry per step), then one fused carry + conditional subtract
    (CIOS output is < 2p for a < 2^256, b < p);
  * `add`/`sub`/`neg` form a + b, a - b + p or p - a (all in [0, 2p)) and
    apply the same single correction, so `neg(0) == 0`.
The correction's 8-word carry chain needs only 2p < 2^256: every field here
has p < 2^255 (BN254's Fq and Fr below 2^254, BLS12-381's Fr below 2^255);
at 12 words, 2p < 2^384 (BLS12-381's Fq, 381 bits).

This module is the plain version of `csrc/field.cuh` and the counterpart of
`kogarashi_tpu/fields/mont.py` and of the plain path of
`kogarashi_tpu/fields/mont_pallas.py`. On the card the NTT, the SpMV and
setup's field math run on it.
"""

from __future__ import annotations

import torch

from .spec import FieldSpec

MASK = 0xFFFF
I64 = torch.int64

_CONST_CACHE: dict = {}


# ---------------------------------------------------------------------------
# layout conversions
# ---------------------------------------------------------------------------


def to_halves(w: torch.Tensor) -> torch.Tensor:
    """(8k, ...) int32 words -> (16k, ...) int64 16-bit halves."""
    u = w.to(I64) & 0xFFFFFFFF
    h = torch.stack([u & MASK, u >> 16], dim=1)
    return h.reshape(2 * w.shape[0], *w.shape[1:])


def to_words(h: torch.Tensor) -> torch.Tensor:
    """(16k, ...) canonical int64 halves -> (8k, ...) int32 words."""
    hh = h.reshape(h.shape[0] // 2, 2, *h.shape[1:])
    u = hh[:, 0] | (hh[:, 1] << 16)
    return (u - ((u >> 31) << 32)).to(torch.int32)


def const_col(v: int, device, ndim: int, n: int = 16) -> torch.Tensor:
    """Int < 2^(16 n) -> (n, 1, ..., 1) int64 halves column on `device`."""
    key = (v, str(device), ndim, n)
    t = _CONST_CACHE.get(key)
    if t is None:
        t = torch.tensor([(v >> (16 * i)) & MASK for i in range(n)], dtype=I64, device=device)
        t = t.reshape((n,) + (1,) * ndim)
        _CONST_CACHE[key] = t
    return t


# ---------------------------------------------------------------------------
# base field on halves
# ---------------------------------------------------------------------------


class Fp:
    """Ops of one prime field on (16, ...) int64 canonical halves."""

    def __init__(self, spec: FieldSpec):
        self.spec = spec
        self.p = spec.p
        self.inv16 = spec.inv16
        self.nw = spec.n_words
        self.nh = 2 * spec.n_words  # 16-bit halves per element

    def _col(self, v: int, device, ndim: int):
        return const_col(v, device, ndim, self.nh)

    def _p(self, like, ndim):
        return self._col(self.p, like.device, ndim)

    def finalize(self, t):
        """Lazy rows (16, ...), |row| < 2^46, value in [0, 2p) -> canonical.

        Pairs of halves are merged into 32-bit rows so the carry chain and
        the borrow chain of (value - p) run together over 8 steps; then one
        select."""
        u = t[0::2] + t[1::2] * 65536
        c1 = c2 = 0
        lims, diffs = [], []
        for j in range(self.nw):
            v = u[j] + c1
            lim = v & 0xFFFFFFFF
            c1 = v >> 32
            d = lim - ((self.p >> (32 * j)) & 0xFFFFFFFF) + c2
            diffs.append(d & 0xFFFFFFFF)
            c2 = d >> 32
            lims.append(lim)
        w = torch.where((c2 == 0).unsqueeze(0), torch.stack(diffs), torch.stack(lims))
        return torch.stack([w & MASK, w >> 16], dim=1).reshape(t.shape)

    def mul(self, a, b):
        """CIOS a*b*R^-1 mod p for a < 2^256, b < p; canonical result."""
        shape = b.shape[1:]
        if a.shape[1:] != shape:
            shape = torch.broadcast_shapes(a.shape[1:], shape)
        nd = len(shape)
        nh = self.nh
        b = b.expand(nh, *shape)
        p = self._p(b, nd)
        t = torch.zeros((2 * nh + 1, *shape), dtype=I64, device=b.device)
        inv = self.inv16
        for i in range(nh):
            t[i : i + nh] += a[i] * b
            m = ((t[i] & MASK) * inv) & MASK
            t[i : i + nh] += m * p
            t[i + 1] += t[i] >> 16
        return self.finalize(t[nh : 2 * nh])

    def sqr(self, a):
        return self.mul(a, a)

    def mul_many(self, pairs):
        """Independent products in one batched multiply (fewer, larger ops)."""
        return _many(self.mul, pairs)

    def add_many(self, pairs):
        return _many(self.add, pairs)

    def sub_many(self, pairs):
        return _many(self.sub, pairs)

    def add(self, a, b):
        return self.finalize(a + b)

    def sub(self, a, b):
        return self.finalize(a - b + self._p(a, max(a.ndim, b.ndim) - 1))

    def neg(self, a):
        return self.finalize(self._p(a, a.ndim - 1) - a)

    def zero(self, shape, device):
        return torch.zeros((self.nh, *shape), dtype=I64, device=device)

    def one(self, shape, device):
        return self._col(self.spec.r1, device, len(shape)).expand(self.nh, *shape).clone()

    def const(self, v: int, shape, device):
        """Standard-form int -> Montgomery halves broadcast to `shape`."""
        return self._col(self.spec.to_mont(v), device, len(shape)).expand(self.nh, *shape)

    def is_zero(self, a):
        return (a == 0).all(dim=0)

    def pow(self, a, e: int):
        """a^e, square-and-multiply MSB first (maps 0 -> 0 for e > 0)."""
        out = self.one(a.shape[1:], a.device)
        for bit in bin(e)[2:]:
            out = self.sqr(out)
            if bit == "1":
                out = self.mul(out, a)
        return out

    def inv(self, a):
        """Fermat inverse a^(p-2); maps 0 -> 0."""
        return self.pow(a, self.p - 2)

    def to_std(self, a):
        return self.mul(a, self._col(1, a.device, a.ndim - 1))

    def from_std(self, a):
        return self.mul(a, self._col(self.spec.r2, a.device, a.ndim - 1))

    def reduce_wide(self, t):
        """Lazy nonnegative rows (16, ...) of any size below 2^62 each ->
        canonical value mod p. With V = lo + hi*2^256:
        V*R = mont(lo, R^2) + mont(hi, R^3); V = mont(V*R, 1)."""
        c = torch.zeros_like(t[0])
        lo = []
        for k in range(self.nh):
            v = t[k] + c
            lo.append(v & MASK)
            c = v >> 16
        lo = torch.stack(lo)
        hi = torch.stack([(c >> (16 * k)) & MASK for k in range(self.nh)])
        nd = t.ndim - 1
        vr = self.add(
            self.mul(lo, self._col(self.spec.r2, t.device, nd)),
            self.mul(hi, self._col(self.spec.r3, t.device, nd)),
        )
        return self.to_std(vr)


class Fp2:
    """Fq2 = Fq[u]/(u^2 + 1) on (32, ...) halves: c0 rows then c1 rows."""

    def __init__(self, base: Fp):
        self.base = base

    @staticmethod
    def split(a):
        return a[:16], a[16:]

    @staticmethod
    def _pair(a):
        """(32, ...) -> (16, 2, ...) view: both components as one batch."""
        return a.reshape(2, 16, *a.shape[1:]).transpose(0, 1)

    @staticmethod
    def _unpair(t):
        return t.transpose(0, 1).reshape(32, *t.shape[2:])

    def mul(self, a, b):
        """Karatsuba: 3 base products, batched into one multiply."""
        F = self.base
        a0, a1 = self.split(a)
        b0, b1 = self.split(b)
        sa, sb = F.add_many([(a0, a1), (b0, b1)])
        m0, m1, m2 = F.mul_many([(a0, b0), (a1, b1), (sa, sb)])
        c0, t = F.sub_many([(m0, m1), (m2, m0)])
        return torch.cat([c0, F.sub(t, m1)])

    def sqr(self, a):
        F = self.base
        a0, a1 = self.split(a)
        s = F.add(a0, a1)
        d = F.sub(a0, a1)
        c0, m = F.mul_many([(s, d), (a0, a1)])
        return torch.cat([c0, F.add(m, m)])

    def mul_many(self, pairs):
        return _many(self.mul, pairs)

    def add_many(self, pairs):
        return _many(self.add, pairs)

    def sub_many(self, pairs):
        return _many(self.sub, pairs)

    def add(self, a, b):
        return self._unpair(self.base.add(self._pair(a), self._pair(b)))

    def sub(self, a, b):
        return self._unpair(self.base.sub(self._pair(a), self._pair(b)))

    def neg(self, a):
        return self._unpair(self.base.neg(self._pair(a)))

    def zero(self, shape, device):
        return torch.zeros((32, *shape), dtype=I64, device=device)

    def one(self, shape, device):
        return torch.cat([self.base.one(shape, device), self.base.zero(shape, device)])

    def const(self, v, shape, device):
        """(c0, c1) standard-form ints -> Montgomery halves."""
        return torch.cat([self.base.const(v[0], shape, device), self.base.const(v[1], shape, device)])

    def is_zero(self, a):
        return (a == 0).all(dim=0)

    def inv(self, a):
        """(a0 - a1 u) / (a0^2 + a1^2): one base-field Fermat inverse."""
        F = self.base
        a0, a1 = self.split(a)
        s0, s1 = F.mul_many([(a0, a0), (a1, a1)])
        ninv = F.inv(F.add(s0, s1))
        c0, c1 = F.mul_many([(a0, ninv), (a1, ninv)])
        return torch.cat([c0, F.neg(c1)])


def _many(op, pairs):
    """Apply a binary op to several same-shaped operand pairs in one call,
    stacked on a new axis 1."""
    a = torch.stack([x for x, _ in pairs], 1)
    b = torch.stack([y for _, y in pairs], 1)
    return op(a, b).unbind(1)


# ---------------------------------------------------------------------------
# public ops on words
# ---------------------------------------------------------------------------

_FIELDS: dict = {}


def field(spec: FieldSpec, ext: int = 1):
    key = (spec.name, ext)
    f = _FIELDS.get(key)
    if f is None:
        base = Fp(spec)
        f = base if ext == 1 else Fp2(base)
        _FIELDS[key] = f
    return f


def _wrap(name):
    def op(*args, spec: FieldSpec, ext: int = 1):
        f = field(spec, ext)
        return to_words(getattr(f, name)(*[to_halves(x) for x in args]))

    op.__name__ = name
    op.__doc__ = f"Word-layout `{name}` (canonical in, canonical out)."
    return op


mul = _wrap("mul")
sqr = _wrap("sqr")
add = _wrap("add")
sub = _wrap("sub")
neg = _wrap("neg")
inv = _wrap("inv")


def to_std(a, spec: FieldSpec):
    """Montgomery words -> standard-form words (base field)."""
    return to_words(field(spec).to_std(to_halves(a)))


def from_std(a, spec: FieldSpec):
    """Standard-form words (< p) -> Montgomery words (base field)."""
    return to_words(field(spec).from_std(to_halves(a)))

