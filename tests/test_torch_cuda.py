"""The CUDA kernels against their plain versions on the card. Marked `cuda`:
without a CUDA device (the CPU test run) every test here skips. On a GPU
machine: python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Imports only the port: the GPU machine has no JAX."""

import random

import numpy as np
import pytest
import torch

from kogarashi_tpu_torch.curves import G1, G2, GRUMPKIN, decode_points, prepare_points, to_affine
from kogarashi_tpu_torch.fields import mont
from kogarashi_tpu_torch.fields.spec import BLS_FR, FQ, FR, MONT_R, ints_to_limbs16
from kogarashi_tpu_torch.ops import ec
from kogarashi_tpu_torch.ops.fixed_base import fixed_base_mul
from kogarashi_tpu_torch.ops.msm import msm
from torch_verify_equation import verify_equation_pairs

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _edge_values(p: int) -> list[int]:
    """Values that stress the carry chains: 0, 1, p - 1, p - 2, R mod p,
    values below p whose top word is p's top word, and values just below p.
    The test multiplies every pair, (p - 1) * (p - 1) among them."""
    top, low = p >> 224, p & ((1 << 224) - 1)
    rng = random.Random(p & 0xFFFF)
    same_top = [top << 224] + [(top << 224) | rng.randrange(low) for _ in range(8)]
    return [0, 1, p - 1, p - 2, MONT_R % p, *same_top, p - 3, p - (1 << 32), p - (1 << 128)]


@pytest.mark.parametrize("spec,name", [(FQ, "fq"), (FR, "fr"), (BLS_FR, "blsfr")],
                         ids=["fq", "fr", "blsfr"])
def test_field_kernel_matches_plain(dev, spec, name):
    rng = np.random.default_rng(1)
    edges = _edge_values(spec.p)
    assert all(0 <= v < spec.p for v in edges)
    vals = [int(v) % spec.p for v in rng.integers(0, 1 << 62, 4096)]
    # every pair of edge values, then random values
    ea = [x for x in edges for _ in edges]
    eb = [y for _ in edges for y in edges]
    a = torch.from_numpy(spec.encode(ea + vals)).to(dev)
    b = torch.from_numpy(spec.encode(eb + vals[::-1])).to(dev)
    for op in ("mul", "sqr", "add", "sub", "neg"):
        args = (a, b) if op in ("mul", "add", "sub") else (a,)
        assert torch.equal(ec.field_op_cuda(name, op, a, b), getattr(mont, op)(*args, spec=spec)), op


CURVES = [G1, G2, GRUMPKIN]
CURVE_IDS = ["g1", "g2", "grumpkin"]


@pytest.mark.parametrize("curve", CURVES, ids=CURVE_IDS)
def test_point_kernels_match_plain(dev, curve):
    sc = np.random.default_rng(2).integers(0, 1 << 16, size=(16, 2048), dtype=np.uint32)
    sc[15] &= 0x3FFF
    p = fixed_base_mul(curve, torch.from_numpy(sc.astype(np.int32)).to(dev))
    q = tuple(t.roll(1, dims=1).contiguous() for t in p)
    scan = tuple(t.reshape(curve.rows, 4, 512).contiguous() for t in p)
    scan_aff = tuple(t.reshape(curve.rows, 4, 512).contiguous() for t in to_affine(curve, p)[:2])
    pairs = [
        (ec.scan_mixed(curve, *scan_aff), ec.scan_mixed_plain(curve, *scan_aff)),
        (ec.map_padd(curve, p, q), ec.map_padd_plain(curve, p, q)),
        (ec.map_pdouble(curve, p, times=5), ec.map_pdouble_plain(curve, p, times=5)),
        (ec.scan_proj(curve, *scan), ec.scan_proj_plain(curve, *scan)),
    ]
    for got, want in pairs:
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("L,C", [(1, 333), (3, 200), (128, 131)], ids=["L1", "ragged", "L128"])
@pytest.mark.parametrize("curve", CURVES, ids=CURVE_IDS)
def test_scan_mixed_and_map_padd_shapes(dev, curve, L, C):
    """K1 at L = 1 and L = 128 and at a C that is not a multiple of the
    block, and K3 at the same ragged lane count, exactly."""
    n = L * C
    sc = np.random.default_rng(L * 1000 + C).integers(0, 1 << 16, size=(16, n), dtype=np.uint32)
    sc[15] &= 0x3FFF
    p = fixed_base_mul(curve, torch.from_numpy(sc.astype(np.int32)).to(dev))
    ax, ay, _ = to_affine(curve, p)
    scan_aff = tuple(t.reshape(curve.rows, L, C).contiguous() for t in (ax, ay))
    got, want = ec.scan_mixed(curve, *scan_aff), ec.scan_mixed_plain(curve, *scan_aff)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    pc = tuple(t[:, :C].contiguous() for t in p)
    qc = tuple(t[:, -C:].contiguous() for t in p)
    got, want = ec.map_padd(curve, pc, qc), ec.map_padd_plain(curve, pc, qc)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("curve", [G1, GRUMPKIN], ids=["g1", "grumpkin"])
def test_msm_on_card_matches_oracle(dev, curve):
    """300 points; Grumpkin's scalars (its group order is q) lie near q."""
    rng = random.Random(3)
    g = curve.pyref_spec.generator
    order = FR.p if curve is G1 else FQ.p
    pts = [rng.randrange(1, order) * g for _ in range(300)]
    ks = [rng.randrange(order) if curve is G1 else order - 1 - rng.randrange(1 << 64) for _ in range(300)]
    x, y, inf = prepare_points(curve, pts, dev)
    out = msm(curve, x, y, inf, torch.from_numpy(ints_to_limbs16(ks)).to(dev))
    want = curve.pyref_spec.identity_affine()
    for p_, k in zip(pts, ks):
        want = want + k * p_
    assert decode_points(curve, out)[0] == want


def _lanes(curve, dev, n, seed):
    """n random projective points on the card (non-trivial Z)."""
    sc = np.random.default_rng(seed).integers(0, 1 << 16, size=(16, n), dtype=np.uint32)
    sc[15] &= 0x3FFF
    sc[0] |= 1
    return tuple(t.contiguous() for t in fixed_base_mul(curve, torch.from_numpy(sc.astype(np.int32)).to(dev)))


def _group_launches(kernel, curve, g):
    return ec.GROUP_LAUNCHES.get(f"{kernel}_{curve.name}", {}).get(g, 0)


@pytest.mark.parametrize("C", [1, 3, 33, 129, 1040, 1 << 16])
@pytest.mark.parametrize("curve", CURVES, ids=CURVE_IDS)
def test_lane_groups_match_plain(dev, curve, C):
    """K4 (t = 16) and K2 (L = 2) at every built lane group, exactly against
    their plain versions, at C lanes: ragged C, C = 1 and a wide C. K4's
    lane 1 is O; K2's chunks 0-3 add P + P, P + (-P), P + O and O + Q."""
    from kogarashi_tpu_torch.ops.msm import pneg

    p = _lanes(curve, dev, C, C)
    ident = ec.identity_words(curve, (1,), dev)
    if C > 1:
        for k in range(3):
            p[k][:, 1] = ident[k][:, 0]
    want = ec.map_pdouble_plain(curve, p, times=16)
    for g in ec.groups("map_pdouble", curve):
        n = _group_launches("map_pdouble", curve, g)
        got = ec.map_pdouble(curve, p, times=16, group=g)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), g
        assert _group_launches("map_pdouble", curve, g) == n + 1

    a, b = _lanes(curve, dev, C, C + 7), _lanes(curve, dev, C, C + 8)
    s = tuple(torch.stack([u, v], dim=1).contiguous() for u, v in zip(a, b))  # (rows, L = 2, C)
    if C >= 4:
        neg = pneg(curve, tuple(t[:, 0, 1:2] for t in s))
        for k in range(3):
            s[k][:, 1, 0] = s[k][:, 0, 0]  # P + P
            s[k][:, 1, 1] = neg[k][:, 0]  # P + (-P)
            s[k][:, 1, 2] = ident[k][:, 0]  # P + O
            s[k][:, 0, 3] = ident[k][:, 0]  # O + Q
    want = ec.scan_proj_plain(curve, *s)
    for g in ec.groups("scan_proj", curve):
        n = _group_launches("scan_proj", curve, g)
        got = ec.scan_proj(curve, *s, group=g)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), g
        assert _group_launches("scan_proj", curve, g) == n + 1


@pytest.mark.parametrize("mode", ["random", "xorshift"])
@pytest.mark.parametrize("name", ["G1", "Grumpkin"])
def test_pedersen_commit_matches_host(dev, name, mode):
    """A Pedersen commit (the MSM over the key's rows on the card) against
    the host loop, on each commitment curve, with a key sampled on the host
    (random.Random) and one from the reference stream (fixed-base multiply
    and to_affine on the card); values near the scalar modulus."""
    from kogarashi_tpu_torch.nova.pedersen import CURVES as KEY_CURVES, PedersenCommitment
    from kogarashi_tpu_torch.pyref import G1_SPEC, GRUMPKIN_SPEC
    from kogarashi_tpu_torch.utils.xorshift import REFERENCE_TEST_SEED, XorShiftRng

    spec = {"G1": G1_SPEC, "Grumpkin": GRUMPKIN_SPEC}[name]
    rng = random.Random(4) if mode == "random" else XorShiftRng.from_seed(REFERENCE_TEST_SEED)
    ck = PedersenCommitment(spec, 9, rng, active=300, device=dev)
    order = KEY_CURVES[name][1]
    pick = random.Random(5)
    m = [order - 1 - pick.randrange(1 << 32) for _ in range(250)] + [0, 1]
    assert ck.commit(m) == ck.commit_host(m)


def _host_route_matrices(shape, l):
    """A, B and C as three COO dicts on the shape's device, z = [u | x | w]
    with len(x) = l - 1."""
    from kogarashi_tpu_torch.ops import spmv

    mats = []
    for rows in (shape.a, shape.b, shape.c):
        ri, ci, vals = zip(*[(i, k if kind == "x" else k + l, c)
                             for i, row in enumerate(rows) for (kind, k), c in row.terms.items()])
        mats.append(spmv.coo_matrix(ri, ci, vals, shape.spec, shape.device))
    return mats


def _host_route_products(shape, mats, u, x, w):
    """(A z, B z, C z) as halves, z encoded on the host (`FieldSpec.encode`)
    and one `spmv.matvec` a matrix: the route R1csShape took before its
    conversions moved to the device."""
    from kogarashi_tpu_torch.ops import spmv

    z = torch.from_numpy(shape.spec.encode([u, *x, *w])).to(shape.device)
    return [mont.to_halves(spmv.matvec(mat, z, shape.m, shape.spec)) for mat in mats]


def _host_route_ints(shape, halves):
    return shape.spec.decode(mont.to_words(halves).cpu().numpy())


def _host_route_sat(shape, mats, u, x, w, e):
    """is_sat_relaxed on the host route."""
    F = mont.field(shape.spec)
    az, bz, cz = _host_route_products(shape, mats, u, x, w)
    ue, ee = (mont.to_halves(torch.from_numpy(shape.spec.encode(v)).to(shape.device)) for v in ([u], e))
    return bool(torch.equal(F.mul(az, bz), F.add(F.mul(ue.expand_as(cz), cz), ee)))


@pytest.mark.parametrize("primary", [True, False], ids=["primary", "secondary"])
def test_nova_cross_term_matches_host_route(dev, primary):
    """The Example's augmented shape (76934 rows primary, 78982 secondary) on
    the card and a relaxed pair drawn from a seed, (u1, x1, W1, E1)
    satisfying and (x2, w2) not: T from R1csShape.cross_term equals the host
    route's T word for word, with no element converted on the host; the pair
    folded with T and r (E = E1 + r T + r^2 E2) satisfies is_sat_relaxed on
    both routes, and one changed E entry fails both."""
    from kogarashi_tpu_torch.nova import R1CS_COUNTS, ExampleFunction, reset_r1cs_counts
    from kogarashi_tpu_torch.nova.augmented import AugmentedFCircuit
    from kogarashi_tpu_torch.nova.relaxed_r1cs import (
        R1csInstance, R1csShape, R1csWitness, RelaxedR1csInstance, RelaxedR1csWitness,
    )
    from kogarashi_tpu_torch.r1cs import BN254_DRIVER, GRUMPKIN_DRIVER, R1CS

    me, other = (BN254_DRIVER, GRUMPKIN_DRIVER) if primary else (GRUMPKIN_DRIVER, BN254_DRIVER)
    cs = R1CS(me)
    AugmentedFCircuit(other_driver=other, fc=ExampleFunction, is_primary=primary, z_0=[0]).generate(cs)
    shape = R1csShape.from_r1cs(cs, dev)
    p, m = shape.p, shape.m
    assert m == (76934 if primary else 78982)
    rng = random.Random(1900 + primary)
    draw = lambda n: [rng.randrange(p) for _ in range(n)]  # noqa: E731
    u1, x1, w1 = rng.randrange(2, p), draw(shape.l()), draw(shape.m_l_1())
    x2, w2 = draw(shape.l()), draw(shape.m_l_1())
    F = mont.field(shape.spec)
    mats = _host_route_matrices(shape, shape.l() + 1)
    az1, bz1, cz1 = _host_route_products(shape, mats, u1, x1, w1)
    az2, bz2, cz2 = _host_route_products(shape, mats, 1, x2, w2)
    u1h = mont.to_halves(torch.from_numpy(shape.spec.encode([u1])).to(dev)).expand_as(cz1)
    e1 = _host_route_ints(shape, F.sub(F.mul(az1, bz1), F.mul(u1h, cz1)))
    e2 = _host_route_ints(shape, F.sub(F.mul(az2, bz2), cz2))
    want = _host_route_ints(shape, F.sub(F.sub(F.add(F.mul(az2, bz1), F.mul(az1, bz2)), F.mul(u1h, cz2)), cz1))

    ident = me.commit_curve.identity_affine()
    i1 = RelaxedR1csInstance(driver=me, commit_w=ident, commit_e=ident, u=u1, x=x1)
    wt1 = RelaxedR1csWitness(w=w1, e=e1)
    reset_r1cs_counts()
    t = shape.cross_term(i1, wt1, R1csInstance(commit_w=ident, x=x2), R1csWitness(w=w2))
    assert t == want
    assert R1CS_COUNTS == {"cross_terms": 1, "host_converted": 0,
                           "device_converted": 2 * (1 + shape.l() + shape.m_l_1()) + 1 + m}

    r = rng.randrange(1, 1 << 128)
    fold = lambda a, b: [(va + r * vb) % p for va, vb in zip(a, b)]  # noqa: E731
    u, x, w = (u1 + r) % p, fold(x1, x2), fold(w1, w2)
    e = [(a + r * b + r * r * c) % p for a, b, c in zip(e1, t, e2)]
    folded = RelaxedR1csInstance(driver=me, commit_w=ident, commit_e=ident, u=u, x=x)
    assert shape.is_sat_relaxed(folded, RelaxedR1csWitness(w=w, e=e))
    assert _host_route_sat(shape, mats, u, x, w, e)
    e[m // 2] = (e[m // 2] + 1) % p
    assert not shape.is_sat_relaxed(folded, RelaxedR1csWitness(w=w, e=e))
    assert not _host_route_sat(shape, mats, u, x, w, e)
    assert R1CS_COUNTS["host_converted"] == 0


# ---------------------------------------------------------------------------
# Edwards kernels E1-E3 (csrc/edwards.cu) and RedDSA batch verification
# ---------------------------------------------------------------------------


def _jubjub_points(n, seed, dev):
    """n random Jubjub points (one in four the identity) on the card, with a
    random Z: [z](x, y, xy, 1) for z != 0 is the same point."""
    from kogarashi_tpu_torch.curves.edwards import JUBJUB
    from kogarashi_tpu_torch.pyref import JUBJUB_SPEC

    rng = random.Random(seed)
    g = JUBJUB_SPEC.generator.to_extended()
    base = [(rng.randrange(1, JUBJUB_SPEC.order) * g).to_affine() for _ in range(8)]
    pts = [JUBJUB_SPEC.identity_affine() if i % 4 == 3 else base[i % 8] for i in range(n)]
    p = JUBJUB.encode_points(pts, dev)
    z = torch.from_numpy(BLS_FR.encode([rng.randrange(1, BLS_FR.p) for _ in range(n)])).to(dev)
    return pts, tuple(mont.mul(c, z, spec=BLS_FR) for c in p)


def test_edwards_kernels_match_plain(dev):
    """E1 (per-lane and broadcast base; k = 0, 1, order - 1, order, 2^256 - 1,
    p - 1 among random 256-bit scalars), E2 (with and without the negation)
    and E3 (t = 1 and 3) exactly against their plain versions, and E1
    against the oracle, on 333 lanes (a ragged last block)."""
    from kogarashi_tpu_torch.curves.edwards import JUBJUB, generator
    from kogarashi_tpu_torch.ops import edwards as E

    n = 333
    pts, p = _jubjub_points(n, 1, dev)
    rng = random.Random(2)
    order = JUBJUB.order
    ks = [0, 1, order - 1, order, (1 << 256) - 1, BLS_FR.p - 1]
    ks += [rng.randrange(1 << 256) for _ in range(n - len(ks))]
    k = torch.from_numpy(ints_to_limbs16(ks)).to(dev)
    for base in (p, generator(JUBJUB, dev)):
        before = E.LAUNCHES["ed_scalar_mul_jubjub"]
        got = E.scalar_mul(JUBJUB, base, k)
        assert E.LAUNCHES["ed_scalar_mul_jubjub"] == before + 1
        want = E.scalar_mul_plain(JUBJUB, base, k)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    got = JUBJUB.decode_points(E.scalar_mul(JUBJUB, p, k))
    for i in (0, 1, 2, 3, 4, 5, 6, 7, n - 1):
        want = JUBJUB.pyref_spec.identity_extended()
        q, kk = pts[i].to_extended(), ks[i]
        while kk:  # the oracle without reducing k mod the order
            if kk & 1:
                want = want + q
            q, kk = q.double(), kk >> 1
        assert got[i] == want.to_affine(), i
    q = tuple(t.roll(1, dims=1).contiguous() for t in p)
    for neg in (False, True):
        assert all(torch.equal(a, b) for a, b in zip(E.map_add(JUBJUB, p, q, neg), E.map_add_plain(JUBJUB, p, q, neg)))
    for times in (1, 3):
        assert all(torch.equal(a, b) for a, b in zip(E.map_double(JUBJUB, p, times), E.map_double_plain(JUBJUB, p, times)))


@pytest.mark.parametrize("n", [1, 31, 2048 + 5])
def test_scalar_mul_lane_groups_match_plain(dev, n):
    """E1 at every built lane group, exactly against its plain version, with
    the per-lane base and the broadcast base (pn = 1), at n lanes: one lane,
    a ragged warp and 2048 + 5 (lanes past the last group and warp). The
    scalars start 2^256 - 1, 0, 1, order - 1, order; each call adds one
    launch under its g."""
    from kogarashi_tpu_torch.curves.edwards import JUBJUB, generator
    from kogarashi_tpu_torch.ops import edwards as E

    _, p = _jubjub_points(n, 4, dev)
    rng = random.Random(5)
    order = JUBJUB.order
    ks = [(1 << 256) - 1, 0, 1, order - 1, order] + [rng.randrange(1 << 256) for _ in range(n)]
    k = torch.from_numpy(ints_to_limbs16(ks[:n])).to(dev)
    for base in (p, generator(JUBJUB, dev)):
        want = E.scalar_mul_plain(JUBJUB, base, k)
        for g in ec.groups("ed_scalar_mul", JUBJUB):
            before = _group_launches("ed_scalar_mul", JUBJUB, g)
            got = E.scalar_mul(JUBJUB, base, k, group=g)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), g
            assert _group_launches("ed_scalar_mul", JUBJUB, g) == before + 1


@pytest.mark.parametrize("n", [1024, 1 << 16])
def test_map_add_lane_groups_match_plain(dev, n):
    """E2 with and without the negation at every built lane group, exactly
    against its plain version, at the signature path's 1024 lanes and at
    2^16; each call adds one launch under its g."""
    from kogarashi_tpu_torch.curves.edwards import JUBJUB
    from kogarashi_tpu_torch.ops import edwards as E

    _, p = _jubjub_points(n, 6, dev)
    q = tuple(t.roll(3, dims=1).contiguous() for t in p)
    for neg in (False, True):
        want = E.map_add_plain(JUBJUB, p, q, neg)
        for g in ec.groups("ed_map_add", JUBJUB):
            before = _group_launches("ed_map_add", JUBJUB, g)
            got = E.map_add(JUBJUB, p, q, neg, group=g)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), (neg, g)
            assert _group_launches("ed_map_add", JUBJUB, g) == before + 1


@pytest.mark.parametrize("n", [1, 17, 1024])
def test_map_double_lane_groups_match_plain(dev, n):
    """E3 at every built lane group and t = 1, 2 and 3, exactly against its
    plain version, at n lanes: one lane, a ragged warp and the signature
    path's 1024; each call adds one launch under its g."""
    from kogarashi_tpu_torch.curves.edwards import JUBJUB
    from kogarashi_tpu_torch.ops import edwards as E

    _, p = _jubjub_points(n, 7, dev)
    for times in (1, 2, 3):
        want = E.map_double_plain(JUBJUB, p, times)
        for g in ec.groups("ed_map_double", JUBJUB):
            before = _group_launches("ed_map_double", JUBJUB, g)
            got = E.map_double(JUBJUB, p, times, group=g)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), (times, g)
            assert _group_launches("ed_map_double", JUBJUB, g) == before + 1


def test_batch_verify_on_card(dev):
    """64 signatures over 8 keys on the card: equal to the host verify, with
    S + 1, a changed message and R bytes that do not decompress rejected."""
    from kogarashi_tpu_torch.pyref import JUBJUB_SPEC
    from kogarashi_tpu_torch.signature import RedDSA, Signature, batch_verify

    rng = random.Random(3)
    keys = [RedDSA().keygen(rng) for _ in range(8)]
    vks, msgs, sigs = [], [], []
    for i in range(64):
        sk, vk = keys[i % 8]
        msgs.append(bytes(rng.randrange(256) for _ in range(32)))
        sigs.append(sk.sign(msgs[-1], rng))
        vks.append(vk)
    sigs[5] = Signature(sigs[5].r_bytes, (sigs[5].s + 1) % JUBJUB_SPEC.order)
    msgs[17] = msgs[17][:-1] + bytes([msgs[17][-1] ^ 1])
    sigs[40] = Signature(b"\xff" * 32, sigs[40].s)
    got = batch_verify(vks, msgs, sigs, device=dev)
    assert got == [v.verify(m, s) for v, m, s in zip(vks, msgs, sigs)]
    assert [i for i, ok in enumerate(got) if not ok] == [5, 17, 40]


def test_generic_scalar_mul_on_card(dev):
    """curves.point.scalar_mul on K3 / K4 against the oracle, G1 and G2."""
    from kogarashi_tpu_torch.curves import point

    rng = random.Random(4)
    for curve in (G1, G2):
        g = curve.pyref_spec.generator
        pts = [rng.randrange(1, FR.p) * g for _ in range(3)] + [curve.pyref_spec.identity_affine()]
        ks = [0, FR.p - 1, (1 << 256) - 1, rng.randrange(1 << 256)]
        x, y, inf = prepare_points(curve, pts, dev)
        p = point.from_affine(curve, x, y, inf)
        out = point.scalar_mul(curve, p, torch.from_numpy(ints_to_limbs16(ks)).to(dev))
        assert decode_points(curve, out) == [k * q for k, q in zip(ks, pts)]
        assert point.on_curve(curve, out).all()


def _fq12_lanes(n, rng, dev):
    """(96, n) Fq12 words on the card: a zero lane, then a lane of p - 1,
    then random ones."""
    vals = [int(v) % FQ.p for v in rng.integers(0, 1 << 62, 12 * n)]
    edges = [0] * 12 + [FQ.p - 1] * 12
    vals[: min(24, 12 * n)] = edges[: 12 * n]
    return torch.from_numpy(FQ.encode(vals)).reshape(8, n, 12).permute(2, 0, 1).reshape(96, n).contiguous().to(dev)


@pytest.mark.parametrize("op", ["mul", "sq", "inv", "frobenius", "conj", "mul_by_034"])
def test_f12_map_matches_plain(dev, op):
    """P3 on 1, 129 and 4096 lanes (a ragged last block among them), zero
    lanes and edge words among the inputs, against its plain version on
    the card; frobenius at every power. Each launch is counted."""
    from kogarashi_tpu_torch.ops import pairing as P

    rng = np.random.default_rng(5)
    for n in (1, 129, 4096):
        a = _fq12_lanes(n, rng, dev)
        b = a.roll(1, dims=1).contiguous()
        second = {"mul": b, "mul_by_034": b[:48].contiguous()}.get(op)
        for power in (range(12) if op == "frobenius" else (0,)):
            before = P.LAUNCHES["f12_map"]
            got = P.f12_map(op, a, second, power)
            torch.cuda.synchronize()
            assert P.LAUNCHES["f12_map"] == before + 1
            assert torch.equal(got, P.map_plain(op, a, second, power)), (op, n, power)


@pytest.mark.parametrize("op", ["mul", "sq", "inv", "frobenius", "conj", "mul_by_034"])
def test_f12_map_routes_match_plain(dev, op):
    """P3 on both routes (the op's schedule on a block a lane; one thread a
    lane) at 1, 3 and 129 lanes, a zero lane and a lane of p - 1 among the
    inputs, against its plain version on the card; frobenius at every power.
    Each launch is counted under its route."""
    from kogarashi_tpu_torch.ops import pairing as P

    rng = np.random.default_rng(6)
    for n in (1, 3, 129):
        a = _fq12_lanes(n, rng, dev)
        b = a.roll(1, dims=1).contiguous()
        second = {"mul": b, "mul_by_034": b[:48].contiguous()}.get(op)
        for power in (range(12) if op == "frobenius" else (0,)):
            want = P.map_plain(op, a, second, power)
            for route in P.ROUTES:
                before = dict(P.ROUTE_LAUNCHES)
                got = P.f12_map(op, a, second, power, route=route)
                torch.cuda.synchronize()
                assert P.ROUTE_LAUNCHES[route] == before[route] + 1, route
                assert torch.equal(got, want), (op, n, power, route)


def test_miller_loop_and_final_exp_match_plain(dev):
    """P1 at 1, 2, 3 and 5 pairs (identity pairs skipped) against its plain
    version on the card and the host's multi_miller_loop; P2 against its
    plain version on the verify equation's Miller value (-> alpha_g1_beta_g2),
    on one (-> one), on zero (-> zero: fp_inv maps 0 to 0) and on a seeded
    Fq12 outside Gt; each call adds exactly one to its kernel's launch count;
    pairing_device(a G1, G2) equals pairing_fast."""
    from kogarashi_tpu_torch import pyref
    from kogarashi_tpu_torch.ops import pairing as P
    from kogarashi_tpu_torch.pyref.pairing_fast import G2Prepared, final_exp_fast, multi_miller_loop, pairing_fast

    def counted(kernel, fn, *args):
        before = P.LAUNCHES[kernel]
        out = fn(*args)
        torch.cuda.synchronize()
        assert P.LAUNCHES[kernel] == before + 1, kernel
        return out

    g1, g2 = pyref.G1_SPEC.generator, pyref.G2_SPEC.generator
    inf = pyref.G1_SPEC.identity_affine()
    ks = [(5, 7), (11, 13), (17, 19), (23, 29), (31, 37)]
    for n in (1, 2, 3, 5):
        pairs = [(a * g1, G2Prepared.from_affine(b * g2)) for a, b in ks[:n]] + [(inf, G2Prepared.from_affine(g2))]
        ml = counted("pair_miller_loop", P.multi_miller_loop_device, pairs, dev)
        assert torch.equal(ml, P.miller_loop_plain(P._encode_prepared(pairs[:-1], dev))), n
        assert P.decode_fq12(ml) == multi_miller_loop(pairs), n
    pairs, pvk = verify_equation_pairs()
    ml = counted("pair_miller_loop", P.multi_miller_loop_device, pairs, dev)
    assert P.decode_fq12(ml) == multi_miller_loop(pairs)
    rng = np.random.default_rng(8)
    outside = pyref.Fq12.from_fq_list([pyref.Fq(int.from_bytes(rng.bytes(32), "little") % FQ.p) for _ in range(12)])
    assert outside * outside.conjugate() != pyref.Fq12.one()
    zero = torch.zeros(96, dtype=torch.int32, device=dev)
    for f, want in ((ml, pvk.alpha_g1_beta_g2), (P.f12_one_words(dev), pyref.Fq12.one()), (zero, None),
                    (P.encode_fq12(outside, dev), final_exp_fast(outside))):
        fe = counted("pair_final_exp", P.final_exp_device, f)
        assert torch.equal(fe, P.final_exp_plain(f))
        assert torch.equal(fe, zero) if want is None else P.decode_fq12(fe) == want
    a = random.Random(3).randrange(1, FR.p)
    assert P.decode_fq12(P.pairing_device(a * g1, g2, dev)) == pairing_fast(a * g1, g2)


def test_dryrun_multichip_nccl_one_rank(dev):
    """The distributed leg under NCCL at world size 1 (the rank on cuda:0),
    at a small size: the dry run holds the H pipeline to the single-device
    pipeline and the MSM to the host oracle (it raises otherwise), and rank 0
    counts each of K1-K4's G1 launches. More ranks than cards raise."""
    import math

    from kogarashi_tpu_torch.parallel import dryrun_multichip
    from kogarashi_tpu_torch.parallel.launch import launch

    rec = dryrun_multichip(1, "nccl", "cuda", log_h=8, log_msm=10)
    assert (rec["world"], rec["backend"], rec["two_d"]) == (1, "nccl", False)
    assert all(rec["launches"][f"{k}_g1"] > 0 for k in ec.KERNELS), rec["launches"]
    assert not any(rec["launches"][f"{k}_{c}"] for k in ec.KERNELS for c in ("g2", "grumpkin"))
    with pytest.raises(RuntimeError, match="CUDA devices"):
        launch(math.sqrt, torch.cuda.device_count() + 1, "nccl", args=(1.0,))


def test_entry_on_the_card(dev):
    """entry()'s fn (the G1 MSM, c = 8, over __graft_entry__.py's 128 points)
    on the card equals entry.oracle(), launching each of K1-K4."""
    from kogarashi_tpu_torch import entry

    fn, args = entry.entry()
    assert args[0].is_cuda
    ec.reset_launches()
    assert decode_points(G1, fn(*args))[0] == entry.oracle()
    assert all(ec.LAUNCHES[f"{k}_g1"] > 0 for k in ec.KERNELS), ec.LAUNCHES


def test_bench_run_on_the_card(dev):
    """bench.run at 2^16 (c = 16, 2 reps) on the card: every call held to the
    oracle (it raises otherwise), bench.py's keys and metric name."""
    from kogarashi_tpu_torch import bench

    result, info = bench.run(16, 16, 2)
    assert set(result) == {"metric", "value", "unit", "vs_baseline"}
    assert result["metric"] == "bn254_g1_msm_point_adds_per_s_2^16"
    assert result["value"] == (1 << 16) * 16 / info["best"] and len(info["times"]) == 2


# ---------------------------------------------------------------------------
# N1 (csrc/ntt.cu) against the plain version, word for word
# ---------------------------------------------------------------------------

NTT_KS = [1, 2, 5, 10, 11, 12, 20]
_DOMAINS: dict = {}


def _domain(k, dev):
    from kogarashi_tpu_torch.ops import ntt

    if k not in _DOMAINS:
        _DOMAINS[k] = ntt.Domain(k, device=dev)
    return _DOMAINS[k]


def _fr_rows(rows, n, seed, dev):
    """(8, rows, n) Fr words: 0, 1, p - 1 and values with p's top word first
    (`_edge_values`), then uniform values below p."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 32, size=(8, rows * n), dtype=np.uint64)
    w[7] %= FR.p >> 224  # the top word below p's: every value below p
    edges = np.array([[(v >> (32 * i)) & 0xFFFFFFFF for v in _edge_values(FR.p)] for i in range(8)], np.uint64)
    cut = min(edges.shape[1], rows * n)
    w[:, :cut] = edges[:, :cut]
    return torch.from_numpy(w.astype(np.uint32).view(np.int32)).reshape(8, rows, n).to(dev)


@pytest.mark.parametrize("layout", ["rows1", "rows3", "transposed"])
@pytest.mark.parametrize("k", NTT_KS)
def test_ntt_kernel_matches_plain(dev, k, layout):
    """Every Domain method on the card equals the plain version on the same
    words: (8, n), (8, 3, n), and a transposed, non-contiguous (8, 2, n) as
    parallel/ntt.py passes its local DFTs."""
    dom = _domain(k, dev)
    n = dom.n
    if layout == "rows1":
        x = _fr_rows(1, n, k, dev)[:, 0]
    elif layout == "rows3":
        x = _fr_rows(3, n, k, dev)
    else:
        x = _fr_rows(1, 2 * n, k, dev).reshape(8, n, 2).transpose(-1, -2)
        assert not x.is_contiguous()
    for method in ("dft", "idft", "coset_dft", "coset_idft", "divide_by_z_on_coset"):
        got = getattr(dom, method)(x)
        assert got.shape == x.shape and got.dtype == torch.int32
        assert torch.equal(got, dom.plain(method, x)), method


@pytest.mark.parametrize("k", NTT_KS)
def test_ntt_kernel_roundtrip(dev, k):
    dom = _domain(k, dev)
    x = _fr_rows(3, dom.n, 100 + k, dev)
    assert torch.equal(dom.idft(dom.dft(x)), x)
    assert torch.equal(dom.coset_idft(dom.coset_dft(x)), x)


def test_ntt_launches_and_refusals(dev):
    """ntt.LAUNCHES counts each launch under its method (a pass each, one for
    the scaling); a CUDA tensor on a non-Fr Domain, or on a CPU Domain, raises."""
    from kogarashi_tpu_torch.ops import ntt

    dom = _domain(20, dev)
    x = _fr_rows(1, dom.n, 7, dev)
    ntt.reset_launches()
    dom.idft(x)
    dom.coset_dft(x)
    dom.divide_by_z_on_coset(x)
    passes = len(ntt.pass_plan(20))
    assert ntt.LAUNCHES == {"dft": 0, "idft": passes, "coset_dft": passes, "coset_idft": 0,
                            "divide_by_z_on_coset": 1}
    with pytest.raises(ValueError, match="N1"):
        ntt.Domain(1, FQ, device=dev).dft(torch.zeros(8, 2, dtype=torch.int32, device=dev))  # Fq: 2-adicity 1
    with pytest.raises(ValueError, match="N1"):
        ntt.Domain(5, device="cpu").dft(torch.zeros(8, 32, dtype=torch.int32, device=dev))
    assert ntt.LAUNCHES["dft"] == 0
