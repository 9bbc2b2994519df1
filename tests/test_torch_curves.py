"""The port's generic batched curve ops (`curves.point`: padd on K3, pdouble
on K4, scalar_mul as 256 x (K4, K3, select), to_affine, from_affine,
on_curve) against the JAX package's `kogarashi_tpu.curves` and the pure-Python
oracle, exactly, on the CPU (the kernels' plain versions), for G1, Grumpkin
and G2. Both packages keep Montgomery form with R = 2^256 and canonical
values, so the projective outputs agree word for word."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kogarashi_tpu.curves import G1 as JG1, G2 as JG2, GRUMPKIN as JGRUMPKIN
from kogarashi_tpu.fields.spec import ints_to_limbs
from kogarashi_tpu_torch import constants as C
from kogarashi_tpu_torch.curves import G1, G2, GRUMPKIN, decode_points, encode_projective
from kogarashi_tpu_torch.curves import point as P
from kogarashi_tpu_torch.fields.spec import ints_to_limbs16
from kogarashi_tpu_torch.interop import words_from_limbs16

torch.set_num_threads(2)  # the suite runs several workers side by side

CASES = {
    "g1": (G1, JG1, C.R),
    "grumpkin": (GRUMPKIN, JGRUMPKIN, C.Q),
    "g2": (G2, JG2, C.R),
}


def _words(jarr, ext: int):
    """A JAX coordinate array ((16, n) or (2, 16, n) limbs) -> (8 * ext, n) words."""
    a = np.asarray(jarr)
    if ext == 2:
        return torch.from_numpy(np.concatenate([words_from_limbs16(a[0]), words_from_limbs16(a[1])]))
    return torch.from_numpy(words_from_limbs16(a))


def _jax_point(jc, pts):
    """The port's pyref points -> the JAX package's, by coordinates, encoded."""
    spec = jc.pyref_spec
    out = []
    for q in pts:
        if q.is_infinity:
            out.append(spec.identity_affine())
        elif hasattr(q.x, "v"):
            out.append(type(spec.generator)(spec, spec.field(q.x.v), spec.field(q.y.v), False))
        else:
            make = spec.field.new
            out.append(type(spec.generator)(spec, make(q.x.c0.v, q.x.c1.v), make(q.y.c0.v, q.y.c1.v), False))
    return jc.encode_points(out)


def _equal(port, jax_pt, ext):
    return all(torch.equal(a, _words(b, ext)) for a, b in zip(port, jax_pt))


# edge scalars: 0, 1, order - 1, order, 2^256 - 1; then random 256-bit values
def _scalars(order, rng):
    return [0, 1, order - 1, order, (1 << 256) - 1, rng.randrange(1 << 256)]


@pytest.fixture(scope="module", params=list(CASES))
def batch(request):
    """Six points per curve (one the identity), in both packages, and the
    port's scalar_mul by the edge scalars (computed once: the plain ladder is
    the costly part)."""
    curve, jc, order = CASES[request.param]
    rng = random.Random(list(CASES).index(request.param))
    g = curve.pyref_spec.generator
    pts = [rng.randrange(1, order) * g for _ in range(5)] + [curve.pyref_spec.identity_affine()]
    ks = _scalars(order, rng)
    p = encode_projective(curve, pts, "cpu")
    k = torch.from_numpy(ints_to_limbs16(ks))
    return dict(curve=curve, jc=jc, order=order, pts=pts, ks=ks, p=p, jp=_jax_point(jc, pts),
                mul=P.scalar_mul(curve, p, k))


def test_padd_pdouble_match_jax_and_oracle(batch):
    curve, jc, pts, p, jp = (batch[k] for k in ("curve", "jc", "pts", "p", "jp"))
    q = tuple(t.roll(1, dims=1).contiguous() for t in p)
    q[0][:, 0], q[1][:, 0], q[2][:, 0] = p[0][:, 0], p[1][:, 0], p[2][:, 0]  # lane 0: P + P
    jq = tuple(jnp.concatenate([c[..., :1], c[..., :-1]], axis=-1) for c in jp)
    qpts = [pts[0]] + pts[:-1]
    s = P.padd(curve, p, q)
    assert _equal(s, jc.add(jp, jq), curve.ext)
    assert decode_points(curve, s) == [a + b for a, b in zip(pts, qpts)]
    d = P.pdouble(curve, p)
    assert _equal(d, jc.double(jp), curve.ext)
    assert decode_points(curve, d) == [a.double() for a in pts]
    ident = P.identity(curve, p[0].shape[1], "cpu")
    assert decode_points(curve, P.padd(curve, p, ident)) == pts


def test_scalar_mul_matches_jax_and_oracle(batch):
    """k = 0, 1, order - 1, order, 2^256 - 1 and a random 256-bit k, over a
    batch whose last lane is the identity."""
    curve, jc, pts, ks, jp, mul = (batch[k] for k in ("curve", "jc", "pts", "ks", "jp", "mul"))
    assert _equal(mul, jc.scalar_mul(jp, jnp.asarray(ints_to_limbs(ks).T)), curve.ext)
    assert decode_points(curve, mul) == [k * q for k, q in zip(ks, pts)]


def test_scalar_mul_broadcast_base():
    """One base point against a batch of scalars (the fixed-base use), G1."""
    curve, order = G1, C.R
    rng = random.Random(7)
    ks = [rng.randrange(order) for _ in range(2)]
    g = P.generator(curve, "cpu")
    got = decode_points(curve, P.scalar_mul(curve, g, torch.from_numpy(ints_to_limbs16(ks))))
    assert got == [k * curve.pyref_spec.generator for k in ks]


def test_affine_and_on_curve_match_jax(batch):
    curve, jc, p, jp, mul = (batch[k] for k in ("curve", "jc", "p", "jp", "mul"))
    ax, ay, inf = P.to_affine(curve, mul)
    jx, jy, jinf = jc.to_affine(jc.scalar_mul(jp, jnp.asarray(ints_to_limbs(batch["ks"]).T)))
    assert torch.equal(ax, _words(jx, curve.ext)) and torch.equal(ay, _words(jy, curve.ext))
    assert inf.tolist() == np.asarray(jinf).tolist()
    back = P.from_affine(curve, ax, ay, inf)
    assert decode_points(curve, back) == decode_points(curve, mul)
    assert P.on_curve(curve, p).tolist() == np.asarray(jc.on_curve(jp)).tolist() == [True] * 6
    bad = (p[0], p[0], p[2])  # Y := X: off the curve, except the identity's (0 : 0 : 0)
    jbad = (jp[0], jp[0], jp[2])
    assert P.on_curve(curve, bad).tolist() == np.asarray(jc.on_curve(jbad)).tolist()
    assert P.is_identity(curve, p).tolist() == [False] * 5 + [True]


def test_pneg_and_select(batch):
    curve, pts, p = batch["curve"], batch["pts"], batch["p"]
    assert decode_points(curve, P.pneg(curve, p)) == [-q for q in pts]
    cond = torch.tensor([True, False] * 3)
    ident = P.identity(curve, 6, "cpu")
    got = decode_points(curve, P.pselect(cond, p, ident))
    assert got == [q if i % 2 == 0 else curve.pyref_spec.identity_affine() for i, q in enumerate(pts)]


def test_scalar_bits_msb_first():
    ks = [1, 1 << 255, 0x8001]
    bits = P.scalar_bits(torch.from_numpy(ints_to_limbs16(ks)))
    for j, k in enumerate(ks):
        assert int("".join(str(int(b)) for b in bits[:, j]), 2) == k
