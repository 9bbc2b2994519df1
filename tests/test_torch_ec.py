"""K1-K4 plain versions (kogarashi_tpu_torch.ops.ec, the path a CPU tensor
takes) against the JAX package's entry points `ec_pallas.map_padd /
map_pdouble / scan_mixed / scan_proj (mode="xla")`, run eagerly inside
`jax.disable_jit()`, and against pyref. G1 and G2 at C = 128, L = 2,
including the identity, P + P and P + (-P). Points are compared decoded to
affine, exactly, by their integer coordinates: the two packages' pyref
classes never compare equal. G1 here; G2 in test_torch_ec_g2.py and
Grumpkin in test_torch_grumpkin.py (same checks)."""

import random

import jax
import numpy as np
import pytest
import torch

from kogarashi_tpu import constants as C
from kogarashi_tpu.curves import G1 as JG1, G2 as JG2, GRUMPKIN as JGRUMPKIN
from kogarashi_tpu.fields import mont_pallas as M
from kogarashi_tpu.ops import ec_pallas as E
from kogarashi_tpu.ops.msm_pallas import curve_k, decode_point
from kogarashi_tpu_torch.curves import G1, G2, GRUMPKIN, decode_points, encode_projective, prepare_points
from kogarashi_tpu_torch.ops import ec

torch.set_num_threads(2)  # the suite runs several workers side by side

CURVES = {"g1": (G1, JG1), "g2": (G2, JG2), "grumpkin": (GRUMPKIN, JGRUMPKIN)}
NC, L = 128, 2


def _pts(curve, seed, m):
    rng = random.Random(seed)
    g = curve.pyref_spec.generator
    base = [rng.randrange(1, C.R) * g for _ in range(16)]
    return [base[int(i)] for i in np.random.default_rng(seed).integers(0, 16, m)]


def coords(pts):
    """Affine points of either package -> ints: (is_infinity, x, y)."""
    def c(v):
        return (v.v,) if hasattr(v, "v") else (v.c0.v, v.c1.v)

    return [(True,) if q.is_infinity else (False, c(q.x), c(q.y)) for q in pts]


def _enc13(jcurve, pts, projective=True):
    """pyref affine points -> JAX 13-bit R' = 2^260 coordinate arrays (rows, m)."""
    ck = curve_k(jcurve)
    p, R, nl, ext = ck.K.p, ck.K.mont_r, ck.K.n, ck.ext

    def comps(v):
        return [v.v] if ext == 1 else [v.c0.v, v.c1.v]

    zero, one = [0] * ext, [1] + [0] * (ext - 1)
    coords = []
    for name in ("x", "y", "z") if projective else ("x", "y"):
        vals = []
        for q in pts:
            if q.is_infinity:
                vals.append(one if name == "y" else zero)
            else:
                vals.append(one if name == "z" else comps(getattr(q, name)))
        rows = np.array([[l for c in v for l in M.limbs13(c * R % p, nl)] for v in vals], np.int32)
        coords.append(jax.numpy.asarray(rows.T))
    return tuple(coords)


def _pair_batches(curve):
    """Lane pairs (P_j, Q_j) covering P+P, P+(-P), O+Q, P+O and random pairs."""
    ps, qs = _pts(curve, 1, NC), _pts(curve, 2, NC)
    ident = curve.pyref_spec.identity_affine()
    qs[0] = ps[0]
    qs[1] = -ps[1]
    ps[2] = ident
    qs[3] = ident
    ps[4] = qs[4] = ident
    return ps, qs


def check_map_padd(name):
    curve, jcurve = CURVES[name]
    ps, qs = _pair_batches(curve)
    got = decode_points(curve, ec.map_padd(curve, encode_projective(curve, ps, "cpu"),
                                           encode_projective(curve, qs, "cpu")))
    assert got == [a + b for a, b in zip(ps, qs)]
    with jax.disable_jit():
        want = E.map_padd(curve_k(jcurve), _enc13(jcurve, ps), _enc13(jcurve, qs), mode="xla")
    assert coords(got) == coords(decode_point(jcurve, want))


def check_map_pdouble(name, times):
    curve, jcurve = CURVES[name]
    ps, _ = _pair_batches(curve)
    got = decode_points(curve, ec.map_pdouble(curve, encode_projective(curve, ps, "cpu"), times=times))
    assert got == [(1 << times) * a for a in ps]
    with jax.disable_jit():
        want = E.map_pdouble(curve_k(jcurve), _enc13(jcurve, ps), mode="xla", times=times)
    assert coords(got) == coords(decode_point(jcurve, want))


def _scan_layout(t, rows):
    """(rows, L*C) element-major -> (rows, L, C), chunk c = elements c*L .. c*L+L-1."""
    return t.reshape(rows, NC, L).transpose(1, 2).contiguous()


def _expected_scan(pts):
    out = []
    for c in range(NC):
        acc = pts[0].spec.identity_affine()
        for j in range(L):
            acc = acc + pts[c * L + j]
            out.append(acc)
    return out  # chunk-major


def _decode_scan(curve, S):
    """(rows, L, C) projective scan outputs -> chunk-major decoded points."""
    flat = tuple(s.transpose(1, 2).reshape(s.shape[0], -1) for s in S)
    return decode_points(curve, flat)


def _decode_scan_jax(jcurve, S):
    flat = tuple(np.asarray(s).transpose(0, 2, 1).reshape(s.shape[0], -1) for s in S)
    return decode_point(jcurve, flat)


def check_scan_mixed(name):
    curve, jcurve = CURVES[name]
    pts = _pts(curve, 3, NC * L)
    pts[5] = -pts[4]  # a chunk whose running sum returns to the identity
    x, y, _ = prepare_points(curve, pts, "cpu")
    got = _decode_scan(curve, ec.scan_mixed(curve, _scan_layout(x, curve.rows), _scan_layout(y, curve.rows)))
    assert got == _expected_scan(pts)
    jx, jy = (np.asarray(a).reshape(-1, NC, L).transpose(0, 2, 1) for a in _enc13(jcurve, pts, False))
    with jax.disable_jit():
        want = E.scan_mixed(curve_k(jcurve), jax.numpy.asarray(jx), jax.numpy.asarray(jy), mode="xla")
    assert coords(got) == coords(_decode_scan_jax(jcurve, want))


def check_scan_proj(name):
    curve, jcurve = CURVES[name]
    pts = _pts(curve, 4, NC * L)
    pts[6] = curve.pyref_spec.identity_affine()
    pts[9] = -pts[8]
    S = ec.scan_proj(curve, *(_scan_layout(t, curve.rows) for t in encode_projective(curve, pts, "cpu")))
    got = _decode_scan(curve, S)
    assert got == _expected_scan(pts)
    j = tuple(jax.numpy.asarray(np.asarray(a).reshape(-1, NC, L).transpose(0, 2, 1)) for a in _enc13(jcurve, pts))
    with jax.disable_jit():
        want = E.scan_proj(curve_k(jcurve), *j, mode="xla")
    assert coords(got) == coords(_decode_scan_jax(jcurve, want))


def test_map_padd_vs_jax_g1():
    check_map_padd("g1")


@pytest.mark.parametrize("times", [1, 3])
def test_map_pdouble_vs_jax_g1(times):
    check_map_pdouble("g1", times)


def test_scan_mixed_vs_jax_g1():
    check_scan_mixed("g1")


def test_scan_proj_vs_jax_g1():
    check_scan_proj("g1")


def test_wrappers_check_inputs():
    x = torch.zeros((8, 2, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        ec.scan_mixed(G2, x, x)  # G2 takes 16 rows
    with pytest.raises(TypeError):
        ec.scan_mixed(G1, x.to(torch.int64), x.to(torch.int64))
    with pytest.raises(ValueError):
        ec.scan_mixed(G1, x.transpose(1, 2), x.transpose(1, 2))


@pytest.mark.parametrize("kernel,curve,shape,times,muls,n_in", [
    ("scan_mixed", G1, (8, 128, 131072), 1, 11, 2),
    ("scan_proj", G2, (16, 8, 65552), 1, 42, 3),
    ("map_padd", G2, (16, 1 << 20), 1, 42, 6),
    ("map_pdouble", G1, (8, 1), 16, 8, 3),
])
def test_bound_ms(kernel, curve, shape, times, muls, n_in):
    """The bound chip_smoke.py reports: 264 32-bit multiply-adds per
    Montgomery multiply at 64 per SM per clock on 132 SMs, or each input
    read and each output written once at 3.35 TB/s, whichever is longer."""
    clock, lanes = 1.98e9, int(np.prod(shape[1:]))
    t_ops = lanes * times * muls * 264 / (132 * 64 * clock) * 1e3
    t_bytes = (n_in + 3) * shape[0] * 4 * lanes / 3.35e12 * 1e3
    ms, by = ec.bound_ms(kernel, curve, shape, clock, times)
    assert ms == pytest.approx(max(t_ops, t_bytes), rel=1e-12)
    assert by == ("operations" if t_ops >= t_bytes else "bytes")


@pytest.mark.parametrize("name", ["g1", "g2", "grumpkin"])
def test_map_pdouble_one_lane_t16(name):
    """K4's plain version at the window combine's shape, one lane and
    t = 16, against pyref: 2^16 * P."""
    curve = CURVES[name][0]
    p = _pts(curve, 7, 1)
    got = ec.map_pdouble(curve, encode_projective(curve, p, "cpu"), times=16)
    assert decode_points(curve, got) == [(1 << 16) * p[0]]


@pytest.mark.parametrize("name", ["g1", "g2", "grumpkin"])
def test_scan_proj_ragged(name):
    """K2's plain version at L = 2 and a C that no lane group divides,
    against pyref prefix sums; chunks hold P + P, P + (-P), P + O, O + Q."""
    curve = CURVES[name][0]
    nc = 5
    pts = _pts(curve, 8, 2 * nc)
    ident = curve.pyref_spec.identity_affine()
    pts[1], pts[3], pts[5], pts[6] = pts[0], -pts[2], ident, ident
    S = ec.scan_proj(curve, *(t.reshape(curve.rows, nc, 2).transpose(1, 2).contiguous()
                              for t in encode_projective(curve, pts, "cpu")))
    flat = tuple(s.transpose(1, 2).reshape(curve.rows, -1) for s in S)
    want = [a for c in range(nc) for a in (ident + pts[2 * c], pts[2 * c] + pts[2 * c + 1])]
    assert decode_points(curve, flat) == want


def test_lane_group_argument():
    x = torch.zeros((8, 2, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        ec.scan_proj(G1, x, x, x, group=3)  # not a built group size
    with pytest.raises(ValueError):
        ec.map_pdouble(G1, (x[:, 0], x[:, 0], x[:, 0]), group=32)


# lane_group's choice at each shape of the main path: K2 at the 13 chunk
# counts of a 2^20-point MSM with c = 16 (test_torch_msm.py holds the list),
# K4 at the window combine's one lane and at 2^16 lanes
_K2_C = (65552, 65536, 32784, 32768, 16400, 16384, 8208, 8192, 4112, 4096, 2064, 2048, 1040)
_LANE_GROUP_CASES = (
    [("scan_proj", "g1", C, g) for C, g in zip(_K2_C, (1, 1, 1, 1, 2, 2, 2, 2, 4, 4, 8, 8, 8))]
    + [("scan_proj", "g2", C, g) for C, g in zip(_K2_C, (1, 1, 1, 1, 1, 1, 8, 8, 8, 8, 8, 8, 16))]
    + [("map_pdouble", "g1", 1, 4), ("map_pdouble", "g1", 1 << 16, 1),
       ("map_pdouble", "g2", 1, 16), ("map_pdouble", "g2", 1 << 16, 1)])


@pytest.mark.parametrize("kernel,name,C,g", _LANE_GROUP_CASES)
def test_lane_group(kernel, name, C, g):
    curve = CURVES[name][0]
    got = ec.lane_group(kernel, curve, C)
    assert got == g
    assert 32 % got == 0 and got in ec.groups(kernel, curve)
