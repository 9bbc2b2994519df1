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
import re
from pathlib import Path

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
from kogarashi_tpu_torch.ops import ec
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
    """E1's bound counts the 256 x 16 + 2 multiplies a lane the ladder needs
    (d T_P once; a doubling's 8 and the fixed base's add's 8 a bit, as no
    doubling reads T; the last add's T), E3's 7 a doubling and the last
    doubling's T; at 1 GHz and 2^16 lanes both are operations-bound."""
    ms, by = E.bound_ms("ed_scalar_mul", 1 << 16, 1e9)
    want = (1 << 16) * (256 * 16 + 2) * 264 / (132 * 64 * 1e9) * 1e3
    assert by == "operations" and abs(ms - want) < 1e-12
    ms, by = E.bound_ms("ed_map_double", 1 << 16, 1e9, times=3)
    want = (1 << 16) * (7 * 3 + 1) * 264 / (132 * 64 * 1e9) * 1e3
    assert by == "operations" and abs(ms - want) < 1e-12


def _extended_words(affine, zs):
    """Affine (x, y) integer pairs and Z values -> (X, Y, T, Z) = (x z, y z,
    x y z, z) as integer lists, and as the port's and the JAX package's words."""
    cols = [[x * z % P for (x, _), z in zip(affine, zs)], [y * z % P for (_, y), z in zip(affine, zs)],
            [x * y * z % P for (x, y), z in zip(affine, zs)], [z % P for z in zs]]
    return (tuple(torch.from_numpy(BLS_FR.encode(c)) for c in cols), tuple(_jax_words(c) for c in cols))


def _fixed_base_add(p, q):
    """p + q as E1 adds its fixed base q, on halves: d T_q and X_q + Y_q
    formed first, so the product T_p (d T_q) stands for eadd_h's d (T_p T_q)."""
    F = JUBJUB.alg
    x0, y0, t0, z0 = p
    x1, y1, t1, z1 = q
    dt1 = F.mul(F.const(JUBJUB.d, t1.shape[1:], t1.device), t1)
    aa, bb, cc, dd, m = F.mul_many([(x0, x1), (y0, y1), (t0, dt1), (z0, z1), (F.add(x0, y0), F.add(x1, y1))])
    h = F.add(aa, bb)
    e = F.sub(m, h)
    f, g = F.sub(dd, cc), F.add(dd, cc)
    return tuple(F.mul_many([(e, f), (g, h), (e, h), (f, g)]))


def test_fixed_base_add_matches_eadd_and_jax():
    """E1's add of the fixed base (d T and X + Y formed once) equals eadd_h
    and the JAX package's eadd word for word, on seeded random Jubjub points
    with random Z, the identity and (0, -1), whose T is 0, on either side:
    the kernel's association gives the plain version's words."""
    rng = random.Random(9)
    pts = [(q.x.v, q.y.v) for q in _rand_points(rng, 6)] + [(0, 1), (0, P - 1)]
    left = pts + pts[::-1]
    right = pts[::-1] + pts
    (p, jp), (q, jq) = (_extended_words(a, [rng.randrange(1, P) for _ in a]) for a in (left, right))
    ph, qh = tuple(mont.to_halves(t) for t in p), tuple(mont.to_halves(t) for t in q)
    got = tuple(mont.to_words(t) for t in _fixed_base_add(ph, qh))
    want = tuple(mont.to_words(t) for t in E.eadd_h(JUBJUB, ph, qh))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert _equal(got, JJUBJUB.add(jp, jq))


def test_lane_group_rule_covers_every_lane_count():
    """E1's and E2's rule gives a built group size for every lane count from
    1 to 2^20, and csrc/edwards.cu builds exactly the sizes it names; the
    one-thread kernel where the measurements keep it (E1 from 32768 lanes,
    E2 at 2^16) and a group at the signature paths' shapes (E1 at 2048 and
    16384 lanes, E2 at 1024 and 8192: 1024 and 8192 signatures)."""
    src = (Path(E.__file__).resolve().parent.parent / "csrc" / "edwards.cu").read_text()
    mask = int(re.search(r"#define KT_ED_GROUPS (0x[0-9a-f]+)", src).group(1), 16)
    for kernel in ("ed_scalar_mul", "ed_map_add"):
        built = ec.groups(kernel, JUBJUB)
        assert {ec.lane_group(kernel, JUBJUB, n) for n in range(1, (1 << 20) + 1)} == set(built)
        assert built == tuple(g for g in range(1, 33) if mask >> g & 1)
    assert ec.lane_group("ed_scalar_mul", JUBJUB, 32768) == 1 and ec.lane_group("ed_map_add", JUBJUB, 1 << 16) == 1
    assert min(ec.lane_group("ed_scalar_mul", JUBJUB, n) for n in (2048, 16384)) > 1
    assert min(ec.lane_group("ed_map_add", JUBJUB, n) for n in (1024, 8192)) > 1
    with pytest.raises(ValueError):
        E.map_add(JUBJUB, *(ED.identity(JUBJUB, 4, "cpu"),) * 2, group=3)


def _double_xyz(p):
    """E3's doublings but the last, on halves: edouble_h's products without
    T = e dd, which the next doubling does not read (T left zero)."""
    F = JUBJUB.alg
    x, y, _, z = p
    xx, bb, zz, xy = F.mul_many([(x, x), (y, y), (z, z), (x, y)])
    aa = F.neg(xx)
    cc, e = F.add_many([(zz, zz), (xy, xy)])
    dd, g = F.sub(aa, bb), F.add(aa, bb)
    f = F.sub(g, cc)
    nx, ny, nz = F.mul_many([(e, f), (g, dd), (f, g)])
    return nx, ny, F.zero(nx.shape[1:], nx.device), nz


@pytest.mark.parametrize("times", [1, 2, 3])
def test_map_double_without_t_matches_edouble_and_jax(times):
    """E3 as the kernel runs it: `times` - 1 doublings that skip T, then one
    that makes it, equal edouble_h `times` times and the JAX package's double
    word for word, on seeded random Jubjub points with random Z, the
    identity and (0, -1)."""
    rng = random.Random(10 + times)
    pts = [(q.x.v, q.y.v) for q in _rand_points(rng, 6)] + [(0, 1), (0, P - 1)]
    p, jp = _extended_words(pts, [rng.randrange(1, P) for _ in pts])
    h = tuple(mont.to_halves(t) for t in p)
    for _ in range(times - 1):
        h = _double_xyz(h)
    got = tuple(mont.to_words(t) for t in E.edouble_h(JUBJUB, h))
    want = E.map_double_plain(JUBJUB, p, times)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    for _ in range(times):
        jp = JJUBJUB.double(jp)
    assert _equal(got, jp)


def test_map_double_lane_group_rule():
    """E3's rule gives a built group size for every lane count from 1 to
    2^20, each in csrc/edwards.cu's KT_ED_GROUPS, which builds exactly the
    sizes E1-E3's rules name; a group at the signature path's 1024 lanes,
    one thread a lane at 2^16; the group argument is checked on the CPU
    too."""
    src = (Path(E.__file__).resolve().parent.parent / "csrc" / "edwards.cu").read_text()
    mask = int(re.search(r"#define KT_ED_GROUPS (0x[0-9a-f]+)", src).group(1), 16)
    built = ec.groups("ed_map_double", JUBJUB)
    assert {ec.lane_group("ed_map_double", JUBJUB, n) for n in range(1, (1 << 20) + 1)} == set(built)
    assert all(mask >> g & 1 for g in built)
    union = {g for k in ("ed_scalar_mul", "ed_map_add", "ed_map_double") for g in ec.groups(k, JUBJUB)}
    assert sorted(union) == [g for g in range(1, 33) if mask >> g & 1]
    assert ec.lane_group("ed_map_double", JUBJUB, 1024) > 1 and ec.lane_group("ed_map_double", JUBJUB, 1 << 16) == 1
    p = ED.identity(JUBJUB, 4, "cpu")
    want = E.map_double_plain(JUBJUB, p, 3)
    for g in built:
        assert all(torch.equal(a, b) for a, b in zip(E.map_double(JUBJUB, p, 3, group=g), want))
    with pytest.raises(ValueError):
        E.map_double(JUBJUB, p, 3, group=3)


def test_floors_count_their_levels():
    """The critical-path floors: E3's 2 levels a doubling (2 t), E2's 3, E1's
    4 a bit over 256 bits, each at one dependent multiply, plus a launch;
    E3's bound still counts 7 multiplies a doubling and the last one's T."""
    cycles, clock, launch = 378.0, 1.98e9, 0.0034
    for t in (1, 2, 3):
        assert E.floor_ms("ed_map_double", cycles, clock, launch, t) == 2 * t * cycles / clock * 1e3 + launch
    assert E.floor_ms("ed_map_add", cycles, clock, launch) == 3 * cycles / clock * 1e3 + launch
    assert E.floor_ms("ed_scalar_mul", cycles, clock, launch) == 4 * 256 * cycles / clock * 1e3 + launch
    assert E.MULS["ed_map_double"] == 7 and E.DOUBLE_LEVELS == 2
