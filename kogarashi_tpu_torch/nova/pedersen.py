"""Pedersen vector commitment on the port's MSM (parity: nova/src/pedersen.rs).

Counterpart of `kogarashi_tpu/nova/pedersen.py`. Key = 2^k + 1 random affine
points; commit(m) = sum m_i * g_i. Only the first `active` points are
materialized (messages are never longer). The key's rows live on the
device, and a commitment is one `ops.msm.msm` over them (G1 for the primary
circuit, Grumpkin for the secondary), its scalars padded with zeros to the
active length, decoded to a pyref affine point.

Two sampling modes, as in the JAX package:
  * `random.Random`: uniform x-rejection sampling on the host (valid because
    G1 and Grumpkin have cofactor 1): two modular pows per candidate;
  * `XorShiftRng` (utils/xorshift.py): the reference's exact stream,
    generator * field_random(order) per point, all 2^k + 1 scalars drawn
    (pedersen.rs:10-13); the points come from one device fixed-base
    multiplication (`ops.fixed_base`, K3) and `curves.to_affine`.
"""

from __future__ import annotations

import torch

from ..constants import Q, R
from ..curves import G1, GRUMPKIN, decode_affine, decode_points, prepare_points, to_affine
from ..devices import resolve
from ..fields.spec import ints_to_limbs16
from ..ops.fixed_base import fixed_base_mul
from ..ops.msm import msm
from ..pyref.curve import AffinePoint

# pyref curve name -> (device curve, group order)
CURVES = {"G1": (G1, R), "Grumpkin": (GRUMPKIN, Q)}


def _sqrt_mod(a: int, p: int, g: int, s: int, t: int):
    """sqrt mod p or None (raw ints; Tonelli-Shanks for p % 4 == 1)."""
    if a == 0:
        return 0
    if p % 4 == 3:
        y = pow(a, (p + 1) // 4, p)
        return y if y * y % p == a else None
    if pow(a, (p - 1) // 2, p) != 1:
        return None
    m, c = s, pow(g, t, p)
    tt, r = pow(a, t, p), pow(a, (t + 1) // 2, p)
    while tt != 1:
        i, tmp = 0, tt
        while tmp != 1:
            tmp = tmp * tmp % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c = i, b * b % p
        tt, r = tt * c % p, r * b % p
    return r


def random_curve_point(spec, rng) -> AffinePoint:
    """Uniform random point via x-rejection (cofactor-1 curves only)."""
    F = spec.field
    p, b = F.p, spec.b.v
    while True:
        x = rng.randrange(p)
        y = _sqrt_mod((x * x % p * x + b) % p, p, F.generator, F.s, F.t)
        if y is None:
            continue
        if rng.randrange(2):
            y = p - y
        return AffinePoint(spec, F(x), F(y), False)


class PedersenCommitment:
    def __init__(self, curve_spec, k: int, rng, active: int | None = None, device=None):
        """curve_spec: pyref CurveSpec (G1 or Grumpkin). The key is logically
        2^k + 1 points; `active` bounds how many are materialized (the
        longest message). The rows live on `device` (None: the card)."""
        self.spec = curve_spec
        self.curve, order = CURVES[curve_spec.name]
        self.key_len = (1 << k) + 1
        n = min(active, self.key_len) if active is not None else self.key_len
        self.n_active = n
        device = resolve(device)
        if hasattr(rng, "field_random"):  # reference-stream mode
            scalars = [rng.field_random(order) for _ in range(self.key_len)]
            s_dev = torch.from_numpy(ints_to_limbs16(scalars[:n])).to(device)
            self.x, self.y, self.inf = to_affine(self.curve, fixed_base_mul(self.curve, s_dev))
            self._g_list = None
        else:
            self._g_list = [random_curve_point(curve_spec, rng) for _ in range(n)]
            self.x, self.y, self.inf = prepare_points(self.curve, self._g_list, device)

    @classmethod
    def from_points(cls, curve_spec, key_len: int, points: list, device=None) -> "PedersenCommitment":
        """A key of logical length `key_len` whose materialized points are
        `points` (the port's pyref affine points), on `device` (None: the
        card)."""
        ck = cls.__new__(cls)
        ck.spec = curve_spec
        ck.curve = CURVES[curve_spec.name][0]
        ck.key_len = key_len
        ck.n_active = len(points)
        ck._g_list = list(points)
        ck.x, ck.y, ck.inf = prepare_points(ck.curve, ck._g_list, resolve(device))
        return ck

    @property
    def g(self) -> list:
        """Key points as pyref affine (decoded once from the device rows)."""
        if self._g_list is None:
            self._g_list = decode_affine(self.curve, self.x, self.y, self.inf)
        return self._g_list

    def commit(self, m: list):
        """sum m_i g_i -> pyref AffinePoint (the port's MSM over the key rows)."""
        n = self.n_active
        if len(m) > n:
            raise ValueError(f"message of {len(m)} elements, longer than the "
                             f"{n} materialized key points")
        scalars = list(m) + [0] * (n - len(m))
        s_dev = torch.from_numpy(ints_to_limbs16(scalars)).to(self.x.device)
        return decode_points(self.curve, msm(self.curve, self.x, self.y, self.inf, s_dev))[0]

    def commit_host(self, m: list):
        """Naive host commit (oracle/cross-check)."""
        acc = self.spec.identity_affine()
        for v, g in zip(m, self.g):
            acc = acc + v * g
        return acc
