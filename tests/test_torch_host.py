"""The port's own host modules (constants, pyref with its pairing and Gt,
r1cs, interop, XorShift, MiMC, serde, poly, ff_compat, BLS12-381's Fq at 12
words) against the JAX package's, on the CPU, and the rule that the
port's entry points run on the card unless a caller asks for the CPU. Points cross between the two
packages by their integer coordinates: their pyref classes never compare
equal."""

import random

import numpy as np
import pytest
import torch

from kogarashi_tpu import constants as JC
from kogarashi_tpu import pyref as jpyref
from kogarashi_tpu.pyref import pairing_fast as jpairing
from kogarashi_tpu.r1cs.vector import SquareChainCircuit as JSquareChainCircuit
from kogarashi_tpu_torch import constants as C
from kogarashi_tpu_torch import interop, pyref
from kogarashi_tpu_torch.curves import G1, G2, edwards, encode_projective, point, prepare_points
from kogarashi_tpu_torch.fields.spec import FQ, FR
from kogarashi_tpu_torch.groth16 import SquareChainCircuit, setup
from kogarashi_tpu_torch.nova import ExampleFunction, PedersenCommitment, PublicParams, R1csShape
from kogarashi_tpu_torch.ops import ntt, pairing, spmv
from kogarashi_tpu_torch.ops.fixed_base import FixedBaseTable
from kogarashi_tpu_torch.pyref import pairing_fast
from kogarashi_tpu_torch.signature import batch_verify

torch.set_num_threads(2)  # the suite runs several workers side by side

CONSTANTS = ["Q", "R", "BN_X", "SIX_X_PLUS_2", "FR_S", "FR_T", "FQ_S", "FQ_T", "FR_GENERATOR",
             "FQ_GENERATOR", "FR_ROOT_OF_UNITY", "FQ_ROOT_OF_UNITY", "G1_B", "G1_GEN",
             "G2_GEN_X", "G2_GEN_Y", "FQ2_XI", "G2_B", "GRUMPKIN_B", "GRUMPKIN_GEN", "MIMC_ROUNDS",
             "CHALLENGE_BITS", "HASH_BITS", "BN_LIMB_WIDTH", "BN_N_LIMBS", "BLS_FR",
             "BLS_FR_GENERATOR", "BLS_FR_S", "BLS_FR_T", "BLS_FR_ROOT_OF_UNITY", "JUBJUB_ORDER",
             "JUBJUB_COFACTOR", "JUBJUB_D", "JUBJUB_GEN", "BLS_FQ"]


def test_constants_match_jax():
    for name in CONSTANTS:
        assert getattr(C, name) == getattr(JC, name), name


@pytest.mark.parametrize("k", [2, 5, 8])
def test_square_chain_matches_jax(k):
    ours, theirs = SquareChainCircuit(1 << k).build(), JSquareChainCircuit(1 << k).build()
    assert ours.z_ints() == theirs.z_ints()
    assert (ours.m, ours.l(), ours.m_l_1()) == (theirs.m, theirs.l(), theirs.m_l_1())
    for (r, c, v), (jr, jc, jv) in zip(ours.matrices_coo(), theirs.matrices_coo()):
        assert np.array_equal(r, jr) and np.array_equal(c, jc)
        assert [int(x) for x in v] == [int(x) for x in jv]


def _jax_point(spec, q):
    """The port's affine point -> the JAX package's, by coordinates."""
    if q.is_infinity:
        return spec.identity_affine()
    make = spec.field if hasattr(q.x, "v") else spec.field.new
    comps = (lambda v: (v.v,)) if hasattr(q.x, "v") else (lambda v: (v.c0.v, v.c1.v))
    return jpyref.AffinePoint(spec, make(*comps(q.x)), make(*comps(q.y)), False)


def _check(pkg, pairs):
    """pkg's verdict on prod e(P_i, Q_i) == 1."""
    loop = pkg.multi_miller_loop([(p, pkg.G2Prepared.from_affine(q)) for p, q in pairs])
    return pkg.final_exp_fast(loop) == type(loop).one()


def test_pairing_fast_matches_jax():
    """e(aG1, bG2) e(-abG1, G2) == 1, and != 1 with ab + 1: the same verdict
    from both packages on the same points."""
    rng = random.Random(5)
    a, b = rng.randrange(1, C.R), rng.randrange(1, C.R)
    g1, g2 = pyref.G1_SPEC.generator, pyref.G2_SPEC.generator
    for ab, want in ((a * b, True), (a * b + 1, False)):
        pairs = [(a * g1, b * g2), (-(ab * g1), g2)]
        jpairs = [(_jax_point(jpyref.G1_SPEC, p), _jax_point(jpyref.G2_SPEC, q)) for p, q in pairs]
        assert _check(pairing_fast, pairs) == want
        assert _check(jpairing, jpairs) == want


def _jax_rows(curve, x, y):
    """The port's affine words -> the JAX MSM's 13-bit R' = 2^260 rows."""
    from kogarashi_tpu.fields import mont_pallas as M

    def rows(words):
        comps = [curve.spec.decode(words[8 * e: 8 * e + 8].numpy()) for e in range(curve.ext)]
        return np.array([[l for c in cs for l in M.limbs13((c << 260) % C.Q, 20)]
                         for cs in zip(*comps)], np.int32)

    return rows(x), rows(y)


def test_params_from_jax_verify_with_port_verifier():
    """A JAX-package `Parameters` in the JAX layouts (its own pyref points,
    13-bit R' = 2^260 query rows, 16-bit COO coefficients) -> params_from_jax.
    The queries and matrices come out as the port's own encoding of the same
    values, and the port's verifier on the converted key accepts a proof made
    with the key's trapdoor (c = (ab - alpha beta - gamma acc) / delta) and
    rejects a tampered public input."""
    from kogarashi_tpu.fields.spec import FR as JFR
    from kogarashi_tpu.groth16.keys import Parameters as JParameters, VerifyingKey as JVerifyingKey
    from kogarashi_tpu.ops.spmv import r1cs_matrices_device
    from kogarashi_tpu_torch.groth16 import Proof, Verifier

    r, rng = C.R, random.Random(6)
    cs = SquareChainCircuit(8).build()
    alpha, beta, gamma, delta, a, b = (rng.randrange(1, r) for _ in range(6))
    ic = [rng.randrange(1, r) for _ in range(cs.l())]
    jg1, jg2 = jpyref.G1_SPEC.generator, jpyref.G2_SPEC.generator
    jvk = JVerifyingKey(alpha * jg1, beta * jg1, beta * jg2, gamma * jg2, delta * jg1,
                        delta * jg2, [s * jg1 for s in ic])

    g1, g2 = pyref.G1_SPEC.generator, pyref.G2_SPEC.generator
    pts = {G1: [k * g1 for k in range(1, 6)] + [pyref.G1_SPEC.identity_affine()],
           G2: [k * g2 for k in range(1, 4)] + [pyref.G2_SPEC.identity_affine()]}
    words = {curve: prepare_points(curve, q, "cpu") for curve, q in pts.items()}

    def query(curve):
        x, y, inf = words[curve]
        return (*_jax_rows(curve, x, y), inf.numpy(), None)

    jp = JParameters(vk=jvk, h=query(G1), l=query(G1), a=query(G1), b_g1=query(G1),
                     b_g2=query(G2), l_pub=cs.l(), n=8, num_wires=cs.l() + cs.m_l_1(),
                     mats=[{k: np.asarray(v) for k, v in m.items()} for m in r1cs_matrices_device(cs, JFR)])
    port = interop.params_from_jax(jp, device="cpu")
    for name, curve in (("h", G1), ("l", G1), ("a", G1), ("b_g1", G1), ("b_g2", G2)):
        assert all(torch.equal(u, v) for u, v in zip(getattr(port, name), words[curve])), name
    for got, want in zip(port.mats, spmv.r1cs_matrices(cs, FR, "cpu")):
        assert all(torch.equal(got[k], want[k]) for k in ("row", "col", "coeff"))

    x = cs.x[1:]
    acc = (ic[0] + sum(xi * s for xi, s in zip(x, ic[1:]))) % r
    c = (a * b - alpha * beta - gamma * acc) * pow(delta, -1, r) % r
    verifier = Verifier(port.vk.prepare())
    proof = Proof(a=a * g1, b=b * g2, c=c * g1)
    assert verifier.verify(proof, x)
    assert not verifier.verify(proof, [x[0], x[1] + 1])


def test_xorshift_stream_matches_jax():
    """next_u32, next_u64, fill_bytes and field_random give the JAX copy's
    stream, from the reference seed and from the all-zero seed."""
    from kogarashi_tpu.utils.xorshift import REFERENCE_TEST_SEED as JSEED, XorShiftRng as JRng
    from kogarashi_tpu_torch.utils.xorshift import REFERENCE_TEST_SEED, XorShiftRng

    assert REFERENCE_TEST_SEED == JSEED
    for seed in (REFERENCE_TEST_SEED, bytes(16)):
        a, b = XorShiftRng.from_seed(seed), JRng.from_seed(seed)
        assert [a.next_u32() for _ in range(257)] == [b.next_u32() for _ in range(257)]
        assert [a.next_u64() for _ in range(33)] == [b.next_u64() for _ in range(33)]
        assert a.fill_bytes(37) == b.fill_bytes(37)
        assert [a.field_random(p) for p in (C.R, C.Q)] == [b.field_random(p) for p in (C.R, C.Q)]


@pytest.mark.parametrize("bits", [128, 252])
def test_mimc_ro_squeeze_matches_jax(bits):
    """The port's pure-Python sponge squeezes what the JAX package's does
    (its native sponge where built), over both field pairings, with points
    (one the identity) and scalars absorbed."""
    from kogarashi_tpu.pyref import MimcRO as JMimcRO

    rng = random.Random(bits)
    for (base, scalar), (jbase, jscalar) in (((pyref.Fq, pyref.Fr), (jpyref.Fq, jpyref.Fr)),
                                             ((pyref.Fr, pyref.Fq), (jpyref.Fr, jpyref.Fq))):
        vals = [rng.randrange(base.p) for _ in range(9)]
        ro, jro = pyref.MimcRO(base, scalar), JMimcRO(jbase, jscalar)
        ro.append_vec([base(v) for v in vals])
        jro.append_vec([jbase(v) for v in vals])
        spec = pyref.G1_SPEC if base is pyref.Fq else pyref.GRUMPKIN_SPEC
        jspec = jpyref.G1_SPEC if base is pyref.Fq else jpyref.GRUMPKIN_SPEC
        for k in (3, 0):
            ro.append_point(k * spec.generator if k else spec.identity_affine())
            jro.append_point(k * jspec.generator if k else jspec.identity_affine())
        got, want = ro.squeeze(bits), jro.squeeze(bits)
        assert type(got) is scalar and got.v == want.v


def test_pyref_edwards_and_subgroup_match_jax():
    """The port's copies of pyref/edwards.py and pyref/subgroup.py: the same
    Jubjub points, compressed bytes and decompression verdicts, and the same
    torsion constants and point verdicts as the JAX package's."""
    from kogarashi_tpu.pyref import edwards as jed, subgroup as jsub
    from kogarashi_tpu_torch.pyref import subgroup as sub

    rng = random.Random(8)
    g, jg = pyref.JUBJUB_SPEC.generator.to_extended(), jed.JUBJUB_SPEC.generator.to_extended()
    for _ in range(3):
        k = rng.randrange(1 << 256)
        a, ja = (k * g).to_affine(), (k * jg).to_affine()
        assert (a.x.v, a.y.v) == (ja.x.v, ja.y.v) and a.to_bytes() == ja.to_bytes()
        b = (a + a.double()).to_affine()
        jb = (ja + ja.double()).to_affine()
        assert (b.x.v, b.y.v) == (jb.x.v, jb.y.v)
    for raw in (bytes(32), b"\x12" + bytes(31), b"\xff" * 32, bytes(rng.randrange(256) for _ in range(32))):
        q, jq = pyref.EdwardsAffine.from_bytes(pyref.JUBJUB_SPEC, raw), jed.EdwardsAffine.from_bytes(
            jed.JUBJUB_SPEC, raw)
        assert (q is None) == (jq is None) and (q is None or (q.x.v, q.y.v) == (jq.x.v, jq.y.v))
    assert (sub.BETA.v, sub.LAMBDA) == (jsub.BETA.v, jsub.LAMBDA)
    assert (sub.PSI_X.c0.v, sub.PSI_X.c1.v, sub.PSI_Y.c0.v, sub.PSI_Y.c1.v) == (
        jsub.PSI_X.c0.v, jsub.PSI_X.c1.v, jsub.PSI_Y.c0.v, jsub.PSI_Y.c1.v)
    k = rng.randrange(1, C.R)
    for spec, jspec in ((pyref.G1_SPEC, jpyref.G1_SPEC), (pyref.G2_SPEC, jpyref.G2_SPEC),
                        (pyref.GRUMPKIN_SPEC, jpyref.GRUMPKIN_SPEC)):
        assert sub.validate_point(k * spec.generator) and jsub.validate_point(k * jspec.generator)
    bad = pyref.AffinePoint(pyref.G1_SPEC, pyref.Fq(123), pyref.Fq(456), False)
    assert not sub.validate_point(bad)


def test_serde_codec_bytes_match_jax():
    """Codec primitives, fields, vectors and points (G1, Grumpkin, the
    identity) encode to the JAX copy's bytes; compact lengths across all
    four SCALE modes."""
    from kogarashi_tpu.utils.serde import Codec as JCodec
    from kogarashi_tpu_torch.utils.serde import Codec

    rng = random.Random(3)
    a, b = Codec(), JCodec()
    for n in (0, 63, 64, 16383, 16384, (1 << 30) - 1, 1 << 30, 1 << 70):
        a.compact(n), b.compact(n)
    a.u8(7).u64(1 << 63).boolean(True), b.u8(7).u64(1 << 63).boolean(True)
    for p in (C.R, C.Q):
        vals = [0, 1, p - 1] + [rng.randrange(p) for _ in range(4)]
        a.field(vals[-1], p).fields(vals, p), b.field(vals[-1], p).fields(vals, p)
    for spec, jspec in ((pyref.G1_SPEC, jpyref.G1_SPEC), (pyref.GRUMPKIN_SPEC, jpyref.GRUMPKIN_SPEC)):
        k = rng.randrange(1, C.R)
        a.point(k * spec.generator).point(spec.identity_affine())
        b.point(k * jspec.generator).point(jspec.identity_affine())
    assert a.bytes() == b.bytes()


def _ints(x):
    """A pyref value of either package (field element, Fq12, Gt, point) -> ints."""
    if hasattr(x, "f"):
        x = x.f
    if hasattr(x, "to_fq_list"):
        return [v.v for v in x.to_fq_list()]
    if hasattr(x, "is_infinity"):
        return ("inf",) if x.is_infinity else (_ints(x.x), _ints(x.y))
    if hasattr(x, "c1"):
        return (x.c0.v, x.c1.v)
    return x.v


def test_pyref_pairing_and_gt_match_jax():
    """The port's copies of pyref/pairing.py (untwist, the affine Miller
    loop, the brute-force final exponentiation) and pyref/gt.py give the JAX
    package's values; e(aP, Q) = [a] e(P, Q) in both."""
    from kogarashi_tpu.pyref import gt as jgt
    from kogarashi_tpu_torch.pyref import gt

    g1, g2 = 3 * pyref.G1_SPEC.generator, 5 * pyref.G2_SPEC.generator
    jg1, jg2 = 3 * jpyref.G1_SPEC.generator, 5 * jpyref.G2_SPEC.generator
    assert [_ints(c) for c in pyref.untwist(g2)] == [_ints(c) for c in jpyref.untwist(jg2)]
    ml, jml = pyref.miller_loop(g1, g2), jpyref.miller_loop(jg1, jg2)
    assert _ints(ml) == _ints(jml)
    e = pyref.final_exp(ml)
    assert _ints(e) == _ints(jpyref.final_exp(jml)) == _ints(pairing_fast.pairing_fast(g1, g2))
    assert pyref.pairing(pyref.G1_SPEC.identity_affine(), g2) == pyref.Fq12.one()
    gen, jgen = gt.Gt.generator(), jgt.Gt.generator()
    assert _ints(gen) == _ints(jgen)
    k = random.Random(2).randrange(C.R)
    for ours, theirs in ((gen * k, jgen * k), (gen + gen.double(), jgen + jgen.double()), (-gen, -jgen),
                         (gen - gen, jgen - jgen)):
        assert _ints(ours) == _ints(theirs)
    assert (gen - gen).is_identity() and gt.Gt.identity().is_identity() and not gen.is_identity()
    assert gt.Gt(e) == gen * 15


POLY_CASES = {
    "evaluate": lambda m, f, at: f(m).evaluate(at),
    "divide": lambda m, f, at: f(m).divide(at).c,
    "t": lambda m, f, at: m.Coefficients.t(16, at),
    "commit": lambda m, f, at: f(m).commit([at * at] * 3 + f(m).c),
    "blind": lambda m, f, at: m.Coefficients(list(f(m).c)).blind(1, random.Random(1), type(at)).c,
    "ops": lambda m, f, at: [(f(m) + f(m)).c, (f(m) - m.Coefficients([at])).c, (f(m) * f(m)).c,
                                  (f(m) * at).c, f(m).format_degree().c, f(m).degree()],
    "points_value": lambda m, f, at: [
        (m.PointsValue(f(m).c) + m.PointsValue(f(m).c)).v, (m.PointsValue(f(m).c) * m.PointsValue(f(m).c)).v,
        (m.PointsValue(f(m).c) - m.PointsValue([at] * 5)).v],
}


@pytest.mark.parametrize("case", list(POLY_CASES))
def test_poly_matches_jax(case):
    """The port's copy of groth16/poly.py gives the JAX package's values on
    the cases of tests/test_poly_errors.py, over each package's Fr."""
    from kogarashi_tpu.groth16 import poly as jpoly
    from kogarashi_tpu_torch.groth16 import poly

    vals = [random.Random(8).randrange(C.R) for _ in range(5)] + [0]
    at = random.Random(9).randrange(C.R)
    out = []
    for mod, Fr in ((poly, pyref.Fr), (jpoly, jpyref.Fr)):
        def f(m, Fr=Fr):
            return m.Coefficients([Fr(v) for v in vals])

        res = POLY_CASES[case](mod, f, Fr(at))
        out.append(repr(res).replace("Fr(", "("))
    assert out[0] == out[1]
    if case == "evaluate":
        assert poly.Coefficients([pyref.Fr(v) for v in vals]).evaluate(pyref.Fr(at)).v == sum(
            v * pow(at, i, C.R) for i, v in enumerate(vals)) % C.R


def test_ff_compat_matches_jax():
    """The port's copy of utils/ff_compat.py: the same field parameters,
    reprs and 97-byte raw points as the JAX package's, and the same
    rejections (truncated, off-curve, non-canonical raw points raise the
    port's MalformedProof; from_slice_unchecked validates nothing)."""
    from kogarashi_tpu.utils import ff_compat as jff
    from kogarashi_tpu_torch.errors import MalformedProof
    from kogarashi_tpu_torch.utils import ff_compat as ff

    for name in ("FR_PARAMS", "FQ_PARAMS"):
        assert vars(getattr(ff, name)) == vars(getattr(jff, name)), name
    assert ff.RAW_SIZE == jff.RAW_SIZE == 97
    rng = random.Random(10)
    for field, jfield in ((pyref.Fr, jpyref.Fr), (pyref.Fq, jpyref.Fq)):
        v = rng.randrange(field.p)
        assert ff.to_repr(field(v)) == jff.to_repr(jfield(v))
        assert ff.from_repr(ff.to_repr(field(v)), field) == field(v)
        assert ff.from_repr(field.p.to_bytes(32, "little"), field) is None
        assert ff.is_odd(field(v)) == jff.is_odd(jfield(v))
    for spec, jspec in ((pyref.G1_SPEC, jpyref.G1_SPEC), (pyref.GRUMPKIN_SPEC, jpyref.GRUMPKIN_SPEC)):
        for k in (1, 12345, rng.randrange(1, 1 << 64)):
            raw = ff.to_raw_bytes(k * spec.generator)
            assert raw == jff.to_raw_bytes(k * jspec.generator)
            assert ff.from_raw_bytes(raw, spec) == ff.from_slice_unchecked(raw, spec) == k * spec.generator
        assert ff.from_raw_bytes(ff.to_raw_bytes(spec.identity_affine()), spec).is_infinity
    raw = ff.to_raw_bytes(pyref.G1_SPEC.generator)
    bad, noncanon = bytearray(raw), bytearray(raw)
    bad[0] ^= 1
    noncanon[0:32] = pyref.G1_SPEC.field.p.to_bytes(32, "little")
    for data in (raw[:-1], bytes(bad), bytes(noncanon)):
        with pytest.raises(MalformedProof):
            ff.from_raw_bytes(data, pyref.G1_SPEC)
    ff.from_slice_unchecked(bytes(bad), pyref.G1_SPEC)


@pytest.mark.parametrize("name", ["BlsFr", "BlsFq"])
def test_wide_field_laws(name):
    """tests/test_fields_wide.py's cases on the port's plain engine, at 8
    words (BLS12-381's Fr) and 12 (its Fq, R = 2^384, the JAX package's
    24-limb width): add/sub/mul/sqr/neg laws, the Fermat inverse (0 -> 0),
    reduce_wide of lazy sums, and the pyref classes' 32- and 48-byte serde;
    the spec's Montgomery constants are the JAX package's."""
    from kogarashi_tpu.fields import spec as jspec
    from kogarashi_tpu.pyref.field import BlsFq as JBlsFq
    from kogarashi_tpu_torch.fields import mont
    from kogarashi_tpu_torch.fields.spec import BLS_FQ, BLS_FR
    from kogarashi_tpu_torch.pyref.edwards import BlsScalar
    from kogarashi_tpu_torch.pyref.field import BlsFq

    spec, js, F = {"BlsFr": (BLS_FR, jspec.BLS_FR, BlsScalar), "BlsFq": (BLS_FQ, jspec.BLS_FQ, BlsFq)}[name]
    assert spec.n_words * 2 == js.n_limbs and (spec.r1, spec.r2, spec.r3) == (js.r1, js.r2, js.r3)
    assert (spec.p, spec.generator, spec.s, spec.root_of_unity) == (js.p, js.generator, js.s, js.root_of_unity)
    p, rng = spec.p, random.Random(11)
    xs, ys = [rng.randrange(p) for _ in range(8)], [rng.randrange(p) for _ in range(8)]
    a, b = torch.from_numpy(spec.encode(xs)), torch.from_numpy(spec.encode(ys))
    assert a.shape == (spec.n_words, 8)

    def dec(t):
        return spec.decode(t.numpy())

    assert dec(mont.sub(mont.add(a, b, spec=spec), b, spec=spec)) == xs
    assert dec(mont.sub(a, a, spec=spec)) == [0] * 8
    assert dec(mont.mul(a, b, spec=spec)) == dec(mont.mul(b, a, spec=spec)) == [x * y % p for x, y in zip(xs, ys)]
    assert dec(mont.sqr(a, spec=spec)) == [x * x % p for x in xs]
    assert dec(mont.add(a, mont.neg(a, spec=spec), spec=spec)) == [0] * 8
    zero = torch.from_numpy(spec.encode([0] * 8))
    assert dec(mont.neg(zero, spec=spec)) == [0] * 8
    inv = dec(mont.inv(a[:, :4], spec=spec))
    assert all(i * x % p == 1 for i, x in zip(inv, xs[:4])) and dec(mont.inv(zero[:, :1], spec=spec)) == [0]
    h = mont.to_halves(a)
    assert spec.decode(mont.to_words(mont.field(spec).reduce_wide(h + h + h)).numpy()) == [3 * x % p for x in xs]
    assert F.p == p and F.n_bytes == 4 * spec.n_words
    x = F.random(rng)
    assert F.from_bytes(x.to_bytes()) == x and F.from_bytes((p + 1).to_bytes(F.n_bytes, "little")) is None
    wide = rng.randrange(1 << (16 * F.n_bytes - 5)).to_bytes(2 * F.n_bytes, "little")
    assert F.from_bytes_wide(wide).v == int.from_bytes(wide, "little") % p
    if name == "BlsFq":
        assert (JBlsFq.p, JBlsFq.s, JBlsFq.t, JBlsFq.n_bytes) == (F.p, F.s, F.t, F.n_bytes)


ENTRY_POINTS = {
    "setup": lambda: setup(SquareChainCircuit(4), random.Random(1)),
    "params_from_jax": lambda: interop.params_from_jax(None),
    "query_from_jax": lambda: interop.query_from_jax(None, 1),
    "from_mont260": lambda: interop.from_mont260(np.zeros((1, 20), np.int32), FQ),
    "prepare_points": lambda: prepare_points(G1, [pyref.G1_SPEC.generator]),
    "encode_projective": lambda: encode_projective(G1, [pyref.G1_SPEC.generator]),
    "FixedBaseTable": lambda: FixedBaseTable(G1, c=1, bits=1),
    "Domain": lambda: ntt.Domain(2),
    "r1cs_matrices": lambda: spmv.r1cs_matrices(SquareChainCircuit(4).build(), FR),
    "PublicParams.setup": lambda: PublicParams.setup(ExampleFunction, ExampleFunction, random.Random(1)),
    "PedersenCommitment": lambda: PedersenCommitment(pyref.GRUMPKIN_SPEC, 2, random.Random(1)),
    "PedersenCommitment.from_points": lambda: PedersenCommitment.from_points(
        pyref.G1_SPEC, 2, [pyref.G1_SPEC.generator]),
    "R1csShape.from_r1cs": lambda: R1csShape.from_r1cs(SquareChainCircuit(4).build()),
    "public_params_from_jax": lambda: interop.public_params_from_jax(None),
    "edwards_from_jax": lambda: interop.edwards_from_jax([np.zeros((16, 1), np.uint32)] * 4),
    "point.identity": lambda: point.identity(G1, 1),
    "point.generator": lambda: point.generator(G2),
    "edwards.identity": lambda: edwards.identity(edwards.JUBJUB, 1),
    "edwards.generator": lambda: edwards.generator(edwards.JUBJUB),
    "JUBJUB.encode_points": lambda: edwards.JUBJUB.encode_points([pyref.JUBJUB_SPEC.generator]),
    "batch_verify": lambda: batch_verify([], [], []),
    "multi_miller_loop_device": lambda: pairing.multi_miller_loop_device([]),
    "pairing_device": lambda: pairing.pairing_device(pyref.G1_SPEC.generator, pyref.G2_SPEC.generator),
    "encode_fq12": lambda: pairing.encode_fq12(pyref.Fq12.one()),
    "fq12_from_jax": lambda: interop.fq12_from_jax(np.zeros((2, 3, 2, 16), np.uint32)),
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """Without `device`, an entry point asks for the card and raises when
    there is none; it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[entry]()


def test_setup_without_device_raises_without_a_card():
    """Decided here, not at import: on a machine with no CUDA device,
    setup() without `device` raises."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        setup(SquareChainCircuit(4), random.Random(1))
