"""The port's BLS12-381 Fr field and Jubjub ops against the JAX package's,
exactly, on the CPU (the kernels' plain versions): the field's plain ops
against `kogarashi_tpu.fields.mont` and against integers, edge values
included; eadd (E2, with eneg folded in), edouble (E3), scalar_mul (E1) with
edge scalars, on_curve, to_affine and the identity test against
`kogarashi_tpu.curves.edwards.JUBJUB` on the same points, carried into the
port by `interop.edwards_from_jax`, and against the pure-Python oracle. Both
packages keep Montgomery form with R = 2^256 and canonical values, so the
outputs agree word for word."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kogarashi_tpu.curves.edwards import JUBJUB as JJUBJUB
from kogarashi_tpu.curves.edwards import from_affine as jfrom_affine, is_identity as jis_identity
from kogarashi_tpu.fields import mont as jmont
from kogarashi_tpu.fields.spec import BLS_FR as JBLS_FR, ints_to_limbs
from kogarashi_tpu.pyref import edwards as jpyref_ed
from kogarashi_tpu_torch import constants as C
from kogarashi_tpu_torch import interop
from kogarashi_tpu_torch.curves import edwards as ED
from kogarashi_tpu_torch.curves.edwards import JUBJUB
from kogarashi_tpu_torch.fields import mont
from kogarashi_tpu_torch.fields.spec import BLS_FR, MONT_R, ints_to_limbs16
from kogarashi_tpu_torch.ops import edwards as E
from kogarashi_tpu_torch.pyref import JUBJUB_SPEC

torch.set_num_threads(2)  # the suite runs several workers side by side

P = C.BLS_FR


def edge_values(p: int) -> list[int]:
    """0, 1, p - 1, p - 2, R mod p, p's top word, values just below p."""
    top = p >> 224
    return [0, 1, p - 1, p - 2, MONT_R % p, top << 224, p - 3, p - (1 << 32), p - (1 << 128)]


@pytest.fixture(scope="module")
def field_inputs():
    rng = random.Random(1)
    edges = edge_values(P)
    a = [x for x in edges for _ in edges] + [rng.randrange(P) for _ in range(40)]
    b = [y for _ in edges for y in edges] + [rng.randrange(P) for _ in range(40)]
    return a, b


def _jax_words(vals):
    """Standard ints -> the JAX package's Montgomery limbs (16, n)."""
    return jnp.asarray(JBLS_FR.encode(vals).T)


def _port_words(jarr):
    return torch.from_numpy(interop.words_from_limbs16(np.asarray(jarr)))


OPS = {
    "mul": (lambda x, y: x * y, lambda a, b: jmont.mont_mul(a, b, JBLS_FR)),
    "sqr": (lambda x, y: x * x, lambda a, b: jmont.square(a, JBLS_FR)),
    "add": (lambda x, y: x + y, lambda a, b: jmont.add(a, b, JBLS_FR)),
    "sub": (lambda x, y: x - y, lambda a, b: jmont.sub(a, b, JBLS_FR)),
    "neg": (lambda x, y: -x, lambda a, b: jmont.neg(a, JBLS_FR)),
}


@pytest.mark.parametrize("op", list(OPS))
def test_bls_fr_plain_ops_match_jax_and_ints(field_inputs, op):
    """Every pair of edge values, then random values: the plain engine's
    result is the integer result mod p and the JAX package's words."""
    a, b = field_inputs
    wa, wb = (torch.from_numpy(BLS_FR.encode(v)) for v in (a, b))
    args = (wa, wb) if op in ("mul", "add", "sub") else (wa,)
    got = getattr(mont, op)(*args, spec=BLS_FR)
    ref, jop = OPS[op]
    assert BLS_FR.decode(got.numpy()) == [ref(x, y) % P for x, y in zip(a, b)]
    assert torch.equal(got, _port_words(jop(_jax_words(a), _jax_words(b))))


def test_bls_fr_spec_matches_jax():
    assert (BLS_FR.p, BLS_FR.generator, BLS_FR.s, BLS_FR.root_of_unity) == (
        JBLS_FR.p, JBLS_FR.generator, JBLS_FR.s, JBLS_FR.root_of_unity)
    assert BLS_FR.r1 == JBLS_FR.r1 and BLS_FR.r2 == JBLS_FR.r2


def _rand_points(rng, n):
    g = jpyref_ed.JUBJUB_SPEC.generator.to_extended()
    return [(rng.randrange(1, C.JUBJUB_ORDER) * g).to_affine() for _ in range(n)]


# edge scalars: 0, 1, order - 1, order, 2^256 - 1, and a random 256-bit k
def _scalars(rng):
    return [0, 1, C.JUBJUB_ORDER - 1, C.JUBJUB_ORDER, (1 << 256) - 1, rng.randrange(1 << 256)]


@pytest.fixture(scope="module")
def jub():
    """Six JAX Jubjub points (one the identity) carried into the port, and
    the port's ladder over them by the edge scalars (computed once)."""
    rng = random.Random(2)
    jpts = _rand_points(rng, 5) + [jpyref_ed.JUBJUB_SPEC.identity_affine()]
    jp = JJUBJUB.encode_points(jpts)
    p = interop.edwards_from_jax(jp, device="cpu")
    ks = _scalars(rng)
    return dict(jpts=jpts, jp=jp, p=p, ks=ks,
                mul=ED.scalar_mul(JUBJUB, p, torch.from_numpy(ints_to_limbs16(ks))))


def _equal(port, jax_pt):
    return all(torch.equal(a, _port_words(b)) for a, b in zip(port, jax_pt))


def _ints(q):
    return (q.x.v, q.y.v)


def test_edwards_from_jax_is_the_ports_encoding(jub):
    pts = [jpyref_ed.EdwardsAffine(JUBJUB_SPEC, JUBJUB_SPEC.field(q.x.v), JUBJUB_SPEC.field(q.y.v))
           for q in jub["jpts"]]
    assert all(torch.equal(a, b) for a, b in zip(jub["p"], JUBJUB.encode_points(pts, "cpu")))
    assert [_ints(q) for q in JUBJUB.decode_points(jub["p"])] == [_ints(q) for q in jub["jpts"]]


def test_eadd_edouble_eneg_match_jax(jub):
    jp, p = jub["jp"], jub["p"]
    jq = tuple(jnp.roll(c, 1, axis=-1) for c in jp)
    q = tuple(t.roll(1, dims=1).contiguous() for t in p)
    assert _equal(ED.eadd(JUBJUB, p, q), JJUBJUB.add(jp, jq))
    assert _equal(ED.eadd(JUBJUB, p, q, neg=True), JJUBJUB.add(jp, JJUBJUB.neg(jq)))
    assert _equal(ED.eneg(JUBJUB, q), JJUBJUB.neg(jq))
    assert _equal(ED.edouble(JUBJUB, p), JJUBJUB.double(jp))
    d3 = jp
    for _ in range(3):
        d3 = JJUBJUB.double(d3)
    assert _equal(ED.edouble(JUBJUB, p, 3), d3)
    # p + p == double(p), p - p == identity
    assert JUBJUB.decode_points(ED.eadd(JUBJUB, p, p)) == JUBJUB.decode_points(ED.edouble(JUBJUB, p))
    assert ED.is_identity(JUBJUB, ED.eadd(JUBJUB, p, p, neg=True)).tolist() == [True] * 6


def test_scalar_mul_matches_jax_and_oracle(jub):
    """k = 0, 1, order - 1, order, 2^256 - 1 and a random 256-bit k, over a
    batch whose last lane is the identity."""
    jp, ks, mul = jub["jp"], jub["ks"], jub["mul"]
    assert _equal(mul, JJUBJUB.scalar_mul(jp, jnp.asarray(ints_to_limbs(ks).T)))
    want = []
    for q, k in zip(jub["jpts"], ks):  # the oracle reduces k mod the order, as the ladder may
        acc, base = jpyref_ed.JUBJUB_SPEC.identity_extended(), q.to_extended()
        while k:
            if k & 1:
                acc = acc + base
            base, k = base.double(), k >> 1
        want.append(_ints(acc.to_affine()))
    assert [_ints(q) for q in JUBJUB.decode_points(mul)] == want


def test_scalar_mul_broadcast_base():
    """One base (the generator) against a batch of scalars."""
    rng = random.Random(3)
    ks = [rng.randrange(C.JUBJUB_ORDER) for _ in range(2)]
    got = ED.scalar_mul(JUBJUB, ED.generator(JUBJUB, "cpu"), torch.from_numpy(ints_to_limbs16(ks)))
    g = JUBJUB_SPEC.generator.to_extended()
    assert JUBJUB.decode_points(got) == [(k * g).to_affine() for k in ks]


def test_affine_on_curve_identity_match_jax(jub):
    jp, p, mul = jub["jp"], jub["p"], jub["mul"]
    jmul = JJUBJUB.scalar_mul(jp, jnp.asarray(ints_to_limbs(jub["ks"]).T))
    ax, ay = ED.to_affine(JUBJUB, mul)
    jx, jy = JJUBJUB.to_affine(jmul)
    assert torch.equal(ax, _port_words(jx)) and torch.equal(ay, _port_words(jy))
    back = ED.from_affine(JUBJUB, ax, ay)
    assert _equal(back, jfrom_affine(JJUBJUB.cfg, jx, jy))
    assert ED.on_curve(JUBJUB, p).tolist() == np.asarray(JJUBJUB.on_curve(jp)).tolist() == [True] * 6
    bad = (p[0], p[0], p[2], p[3])
    jbad = (jp[0], jp[0], jp[2], jp[3])
    assert ED.on_curve(JUBJUB, bad).tolist() == np.asarray(JJUBJUB.on_curve(jbad)).tolist()
    assert ED.is_identity(JUBJUB, mul).tolist() == np.asarray(jis_identity(JJUBJUB.cfg, jmul)).tolist()
    assert ED.is_identity(JUBJUB, ED.identity(JUBJUB, 2, "cpu")).tolist() == [True, True]


def test_kernel_wrappers_check_their_inputs(jub):
    p = jub["p"]
    with pytest.raises(ValueError):
        E.map_add(JUBJUB, p, tuple(t[:, :3].contiguous() for t in p))
    with pytest.raises(TypeError):
        E.map_double(JUBJUB, tuple(t.to(torch.int64) for t in p))
    with pytest.raises(ValueError):
        E.scalar_mul(JUBJUB, p, torch.zeros((16, 4), dtype=torch.int32))


def test_bound_counts_the_ladder():
    """E1's bound counts 256 x 17 multiplies a lane; at 1 GHz and 2^16
    lanes that is operations-bound."""
    ms, by = E.bound_ms("ed_scalar_mul", 1 << 16, 1e9)
    want = (1 << 16) * 256 * 17 * 264 / (132 * 64 * 1e9) * 1e3
    assert by == "operations" and abs(ms - want) < 1e-12
