"""Port Pippenger MSM (kogarashi_tpu_torch.ops.msm) on the CPU: digit recode
against the JAX package's `signed_digits`, and whole MSMs against the pyref
oracle with repeated bases, identities and zero scalars (as
tests/test_msm_pallas.py does). Exact equality throughout."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kogarashi_tpu import constants as C
from kogarashi_tpu.ops.msm_pallas import signed_digits as jax_signed_digits
from kogarashi_tpu_torch.curves import G1, G2, decode_points, encode_projective, prepare_points
from kogarashi_tpu_torch.fields.spec import ints_to_limbs16
from kogarashi_tpu_torch.ops import msm as M

torch.set_num_threads(2)  # the suite runs several workers side by side

CURVES = {"g1": G1, "g2": G2}


def _scalars(n, seed):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    return [int.from_bytes(r.astype("<u4").tobytes(), "little") % C.R for r in raw]


@pytest.mark.parametrize("c", [6, 8, 12, 13, 16])
def test_signed_digits_match_jax(c):
    ks = _scalars(61, c) + [0, 1, C.R - 1]
    n_windows = -(-256 // c)
    limbs = ints_to_limbs16(ks)
    got = M.signed_digits(torch.from_numpy(limbs), c, n_windows).numpy()
    want = np.asarray(jax_signed_digits(jnp.asarray(limbs.astype(np.uint32)), c, n_windows))
    assert np.array_equal(got, want)
    for j, k in enumerate(ks):
        assert sum(int(got[w, j]) << (c * w) for w in range(n_windows)) == k
    assert np.abs(got).max() <= 1 << (c - 1)


def _oracle(pts, ks, curve):
    acc = curve.pyref_spec.identity_affine()
    for p, k in zip(pts, ks):
        acc = acc + (k % C.R) * p
    return acc


@pytest.mark.parametrize(
    "name,n,c", [("g1", 512, 8), ("g1", 512, 12), ("g1", 100, None), ("g2", 64, 8)],
    ids=["g1-512-c8", "g1-512-c12", "g1-100-default", "g2-64-c8"],
)
def test_msm_vs_oracle(name, n, c, monkeypatch):
    """Also: the scan_proj (K2) launches the MSM makes are the ones
    `scan_proj_launches` works out."""
    curve = CURVES[name]
    rng = random.Random(n)
    g = curve.pyref_spec.generator
    base = [rng.randrange(1, C.R) * g for _ in range(32)]
    pts = [base[i % 32] for i in range(n)]  # heavy repetition
    pts[5] = pts[17] = curve.pyref_spec.identity_affine()
    ks = _scalars(n - 4, n) + [0, 0, 1, C.R - 1]
    x, y, inf = prepare_points(curve, pts, "cpu")
    seen = {}
    real = M.ec.scan_proj

    def spy(curve_, *xyz):
        seen[tuple(xyz[0].shape[1:])] = seen.get(tuple(xyz[0].shape[1:]), 0) + 1
        return real(curve_, *xyz)

    monkeypatch.setattr(M.ec, "scan_proj", spy)
    out = M.msm(curve, x, y, inf, torch.from_numpy(ints_to_limbs16(ks)), c=c)
    assert decode_points(curve, out)[0] == _oracle(pts, ks, curve)
    assert sorted(seen.items()) == sorted(M.scan_proj_launches(n, c or M.default_window(n)))


def test_msm_all_zero_scalars():
    g = G1.pyref_spec.generator
    pts = [k * g for k in range(1, 65)]
    x, y, inf = prepare_points(G1, pts, "cpu")
    out = M.msm(G1, x, y, inf, torch.zeros((16, 64), dtype=torch.int32), c=8)
    assert decode_points(G1, out)[0].is_infinity


def test_prefix_and_reduce_rows():
    """inclusive_prefix / reduce_points on a (rows, B, m) batch with m > 128
    (chunk scans, recursive chunk offsets, Kogge-Stone tail)."""
    rng = random.Random(3)
    g = G1.pyref_spec.generator
    m, B = 300, 2
    rows = [[rng.randrange(C.R) * g for _ in range(m)] for _ in range(B)]
    rows[1][7] = G1.pyref_spec.identity_affine()
    enc = [encode_projective(G1, r, "cpu") for r in rows]
    batch = tuple(torch.stack([e[k] for e in enc], dim=1) for k in range(3))
    pre = M.inclusive_prefix(G1, batch)
    tot = M.reduce_points(G1, batch)
    for b in range(B):
        acc, want = G1.pyref_spec.identity_affine(), []
        for p in rows[b]:
            acc = acc + p
            want.append(acc)
        assert decode_points(G1, tuple(t[:, b] for t in pre)) == want
        assert decode_points(G1, tuple(t[:, b] for t in tot)) == [acc]


def test_scan_depth():
    assert M.scan_depth(100) == 2
    assert M.scan_depth(1 << 20) == 16
    assert M.scan_depth(16 << 20) == 128
    assert M.default_window(512) == 8 and M.default_window(1 << 12) == 12


def test_scan_proj_launches_2pow20():
    """K2's 20 launches at 13 shapes in one 2^20-point MSM with c = 16."""
    assert M.scan_proj_launches(1 << 20, 16) == [
        ((8, 65552), 2), ((2, 65536), 1), ((2, 32784), 2), ((2, 32768), 1), ((2, 16400), 2),
        ((2, 16384), 1), ((2, 8208), 2), ((2, 8192), 1), ((2, 4112), 2), ((2, 4096), 1),
        ((2, 2064), 2), ((2, 2048), 1), ((2, 1040), 2)]
