"""Pippenger MSM on the point kernels.

Counterpart of `kogarashi_tpu/ops/msm_pallas.py::msm_pallas` (:212). Per
c-bit signed window:

  1. signed digit recode (`signed_digits`, :136): |digit| <= 2^(c-1);
  2. stable sort of |digit| (`torch.sort`), then a gather of the point words
     and signs into sorted order; negative digits negate y (0 stays 0);
  3. `scan_mixed` (K1): per-chunk inclusive prefix sums, layout (rows, L, C);
  4. chunk totals -> `inclusive_prefix` (:94) -> exclusive chunk offsets;
  5. bucket_b = S[tail_b] - S[start_b - 1] (the difference trick, :313-354):
     every scanned lane is a valid group element, so segment differences of
     the global prefix are exact;
  6. G_w = sum_b b * bucket_b = sum of suffix sums (`reduce_points`, :117);
  7. MSB-first combine: acc = 2^c * acc + G_w (:383-388), with `map_pdouble`
     (K4) fusing the c doublings.

Identity inputs become the generator with digit 0 (:257-261): bucket 0 is
never read, and every lane stays a valid group element. Padding uses the
same trick.

Inputs: x, y (rows, n) int32 affine Montgomery words (`curves.prepare_points`),
inf (n,) bool, scalars (16, n) standard-form 16-bit limbs (any int dtype).
The result is one projective point, three (rows, 1) word tensors.
"""

from __future__ import annotations

import torch

from ..curves import Curve
from ..fields import mont
from . import ec

I64 = torch.int64


def default_window(n: int) -> int:
    """Window width heuristic (msm_pallas.py:192)."""
    if n < (1 << 10):
        return 8
    if n < (1 << 16):
        return 12
    return 16


def scan_depth(m: int) -> int:
    """Scan depth L (a power of two in [2, 128]) for m elements: deep enough
    that C = m / L stays near 2^16 chunk threads, about 4 waves of 128-thread
    blocks on 132 SMs."""
    L = 2
    while L < 128 and (L * 2) << 16 <= m:
        L *= 2
    return L


def signed_digits(scalars, c: int, n_windows: int):
    """(16, n) standard-form 16-bit limbs -> (n_windows, n) int64 digits in
    [-2^(c-1), 2^(c-1)] with sum_w d_w 2^(c w) == scalar (msm_pallas.py:136).
    The top window absorbs the final carry."""
    s = scalars.to(I64) & 0xFFFF
    n = s.shape[-1]
    pad = torch.cat([s, torch.zeros((2, n), dtype=I64, device=s.device)])
    carry = torch.zeros(n, dtype=I64, device=s.device)
    half = 1 << (c - 1)
    out = []
    for w in range(n_windows):
        limb, shift = divmod(w * c, 16)
        raw = pad[limb] | (pad[limb + 1] << 16) | (pad[limb + 2] << 32)
        t = ((raw >> shift) & ((1 << c) - 1)) + carry
        sign = (t >= half) & (w + 1 < n_windows)
        out.append(torch.where(sign, t - (1 << c), t))
        carry = sign.to(I64)
    return torch.stack(out)


# ---------------------------------------------------------------------------
# projective batch helpers. A batch is a tuple of (rows, B, m) word tensors:
# B independent rows of m points (B = the MSM's windows), so one launch
# serves every window.
# ---------------------------------------------------------------------------


def _cat(*batches):
    return tuple(torch.cat(cs, dim=-1) for cs in zip(*batches))


def _where(mask, a, b):
    return tuple(torch.where(mask[None], x, y) for x, y in zip(a, b))


def pneg(curve: Curve, p):
    return (p[0], mont.neg(p[1], spec=curve.spec, ext=curve.ext), p[2])


def padd(curve: Curve, p, q):
    """map_padd (K3) on (rows, B, m) batches."""
    shape = p[0].shape
    flat = lambda t: t.reshape(shape[0], -1).contiguous()
    out = ec.map_padd(curve, tuple(flat(t) for t in p), tuple(flat(t) for t in q))
    return tuple(o.reshape(shape) for o in out)


def _pad(curve: Curve, pts, m_to: int):
    rows, B, m = pts[0].shape
    if m == m_to:
        return pts
    return _cat(pts, ec.identity_words(curve, (B, m_to - m), pts[0].device))


def _to_scan(a, L: int, C: int):
    """(rows, B, L*C) -> (rows, L, B*C): element s of row b is chunk
    b*C + s // L, position s % L."""
    rows, B, _ = a.shape
    return a.reshape(rows, B, C, L).permute(0, 3, 1, 2).reshape(rows, L, B * C).contiguous()


def _from_scan(S, B: int):
    """(rows, L, B*C) -> (rows, B, L*C)."""
    rows, L, BC = S.shape
    return S.reshape(rows, L, B, BC // B).permute(0, 2, 3, 1).reshape(rows, B, -1)


def _last(S, B: int):
    """Chunk totals: position L-1 of every chunk -> (rows, B, C)."""
    return S[:, -1, :].reshape(S.shape[0], B, -1)


def _exclusive(curve: Curve, tp):
    rows, B, _ = tp[0].shape
    return _cat(ec.identity_words(curve, (B, 1), tp[0].device), tuple(t[..., :-1] for t in tp))


def _kogge_prefix(curve: Curve, pts):
    """Inclusive prefix over <= 128 points per row by shift-and-add."""
    rows, B, m = pts[0].shape
    cur = pts
    shift = 1
    while shift < m:
        shifted = _cat(ec.identity_words(curve, (B, shift), cur[0].device),
                       tuple(c[..., :-shift] for c in cur))
        cur = padd(curve, cur, shifted)
        shift *= 2
    return cur


def inclusive_prefix(curve: Curve, pts):
    """Inclusive prefix sums along the last axis of a (rows, B, m) batch
    (msm_pallas.py:94): chunk scans (K2), a recursive prefix of the chunk
    totals, then one add of each chunk's offset (K3)."""
    rows, B, m = pts[0].shape
    if m <= 128:
        return _kogge_prefix(curve, pts)
    L = scan_depth(B * m)
    C = -(-m // L)
    S = ec.scan_proj(curve, *(_to_scan(c, L, C) for c in _pad(curve, pts, L * C)))
    tpe = _exclusive(curve, inclusive_prefix(curve, tuple(_last(s, B) for s in S)))
    off = tuple(t.repeat_interleave(L, dim=-1) for t in tpe)
    out = padd(curve, tuple(_from_scan(s, B) for s in S), off)
    return tuple(o[..., :m] for o in out)


def reduce_points(curve: Curve, pts):
    """Row totals of a (rows, B, m) batch -> (rows, B, 1) (msm_pallas.py:117)."""
    rows, B, m = pts[0].shape
    while m > 128:
        L = scan_depth(B * m)
        C = -(-m // L)
        S = ec.scan_proj(curve, *(_to_scan(c, L, C) for c in _pad(curve, pts, L * C)))
        pts = tuple(_last(s, B) for s in S)
        m = C
    return tuple(o[..., m - 1 : m] for o in _kogge_prefix(curve, pts))


def _windows(curve: Curve, x, y, digits, nb: int, L: int):
    """G_w = sum_i d_wi P_i for all windows at once -> (rows, W, 1).
    n is a multiple of the scan depth L."""
    W, n = digits.shape
    dev = digits.device
    C = n // L
    ds, perm = torch.sort(digits.abs(), dim=1, stable=True)
    neg = torch.gather(digits < 0, 1, perm)
    xg = x[:, perm]  # (rows, W, n)
    yg = torch.where(neg[None], mont.neg(y, spec=curve.spec, ext=curve.ext)[:, perm], y[:, perm])

    S = ec.scan_mixed(curve, _to_scan(xg, L, C), _to_scan(yg, L, C))
    tpe = _exclusive(curve, inclusive_prefix(curve, tuple(_last(s, W) for s in S)))

    # bucket endpoints in sorted order; column nb collects the non-members
    minus1 = torch.full((W, 1), -1, dtype=I64, device=dev)
    is_tail = (ds != torch.cat([ds[:, 1:], minus1], dim=1)) & (ds > 0)
    is_start = (ds != torch.cat([minus1, ds[:, :-1]], dim=1)) & (ds > 0)
    iota = torch.arange(n, dtype=I64, device=dev).expand(W, -1)
    tail_pos = torch.full((W, nb + 1), -1, dtype=I64, device=dev)
    tail_pos.scatter_(1, torch.where(is_tail, ds, nb), iota)
    start_pos = torch.full((W, nb + 1), -1, dtype=I64, device=dev)
    start_pos.scatter_(1, torch.where(is_start, ds, nb), iota)
    tail_pos, start_pos = tail_pos[:, :nb], start_pos[:, :nb]
    ident = ec.identity_words(curve, (W, nb), dev)
    rows = S[0].shape[0]
    flatS = tuple(s.reshape(rows, -1) for s in S)
    wbase = (torch.arange(W, device=dev) * C)[:, None]

    def gather_S(pos):
        """Global prefix at sorted position pos (< 0 -> identity)."""
        pc = pos.clamp(0, n - 1)
        cc, jj = pc // L, pc % L
        vals = tuple(f[:, jj * (W * C) + wbase + cc] for f in flatS)
        idx = cc[None].expand(rows, -1, -1)
        offs = tuple(torch.gather(t, 2, idx) for t in tpe)
        return _where(pos >= 0, padd(curve, vals, offs), ident)

    B = _where(tail_pos >= 0,
               padd(curve, gather_S(tail_pos), pneg(curve, gather_S(start_pos - 1))), ident)

    # G_w = sum_{b >= 1} T_b with T_b = sum_{b' >= b} B_b'
    T = tuple(t.flip(-1) for t in inclusive_prefix(curve, tuple(b.flip(-1) for b in B)))
    return padd(curve, reduce_points(curve, T), pneg(curve, tuple(t[..., 0:1] for t in T)))


def msm(curve: Curve, x, y, inf, scalars, c: int | None = None):
    """sum_i scalars[i] * P_i. Returns (X, Y, Z), each (rows, 1) words."""
    rows, n = x.shape
    dev = x.device
    if c is None:
        c = default_window(n)
    n_windows = -(-256 // c)
    L = scan_depth(n_windows * n)
    pad = -n % L
    if pad:  # identity points with zero scalars
        x = torch.cat([x, torch.zeros((rows, pad), dtype=x.dtype, device=dev)], dim=1)
        y = torch.cat([y, torch.zeros((rows, pad), dtype=y.dtype, device=dev)], dim=1)
        inf = torch.cat([inf, torch.ones(pad, dtype=torch.bool, device=dev)])
        scalars = torch.cat([scalars.to(I64), torch.zeros((scalars.shape[0], pad), dtype=I64, device=dev)], dim=1)
    gx, gy = (torch.from_numpy(g).to(dev)[:, None] for g in curve.generator_words())
    x = torch.where(inf[None], gx, x)
    y = torch.where(inf[None], gy, y)
    scal = scalars.to(I64) * (~inf).to(I64)[None]
    digits = signed_digits(scal, c, n_windows)

    G = _windows(curve, x, y, digits, (1 << (c - 1)) + 1, L)  # (rows, W, 1)
    return window_combine(curve, G, c)


def window_combine(curve: Curve, G, c: int):
    """MSB-first acc = 2^c * acc + G_w over the (rows, W, 1) window sums
    (msm_pallas.py:383-388): W - 1 rounds of K4 (c doublings) and K3, each
    at one lane."""
    acc = tuple(g[:, -1].contiguous() for g in G)
    for w in range(G[0].shape[1] - 2, -1, -1):
        acc = ec.map_pdouble(curve, acc, times=c)
        acc = ec.map_padd(curve, acc, tuple(g[:, w].contiguous() for g in G))
    return acc


def scan_proj_launches(n: int, c: int) -> list:
    """The scan_proj (K2) launches one `msm` over n points with window c
    makes, worked out from `scan_depth` as `inclusive_prefix` and
    `reduce_points` recurse: [((L, C), launches)], largest L * C first.
    Three recursions of (W, m) rows: the prefix of K1's chunk totals
    (m = n / L), and the prefix and the reduction of the bucket suffix sums
    (m = 2^(c-1) + 1 buckets)."""
    W = -(-256 // c)
    L0 = scan_depth(W * n)
    counts: dict = {}
    for m in (-(-n // L0), (1 << (c - 1)) + 1, (1 << (c - 1)) + 1):
        while m > 128:
            L = scan_depth(W * m)
            m = -(-m // L)
            counts[(L, W * m)] = counts.get((L, W * m), 0) + 1
    return sorted(counts.items(), key=lambda kv: -kv[0][0] * kv[0][1])
