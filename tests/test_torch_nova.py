"""The port's Nova (kogarashi_tpu_torch.nova) against the JAX package's, on
the CPU: the augmented step circuits (shapes, matrices and witnesses), their
witness-only synthesis (`WitnessCS`) against the full one, the Pedersen keys in both sampling modes, commit against commit_host, NIFS folds
over both drivers with the same keys (carried over by `interop`), the shape's
cross term and relaxed check against plain ints, and, marked
slow, the full 3-step chain under the reference seed against the JAX
package's proof digest. Values cross between the packages as ints: their
pyref classes never compare equal."""

import hashlib
import random

import pytest
import torch

from kogarashi_tpu.nova import ExampleFunction as JExampleFunction, PublicParams as JPublicParams
from kogarashi_tpu.nova.augmented import AugmentedFCircuit as JAugmented
from kogarashi_tpu.nova.nifs import NifsProver as JNifsProver, NifsVerifier as JNifsVerifier
from kogarashi_tpu.nova.pedersen import PedersenCommitment as JPedersen
from kogarashi_tpu.nova.proof import RecursiveProof as JRecursiveProof
from kogarashi_tpu.nova.relaxed_r1cs import (
    R1csInstance as JR1csInstance,
    R1csShape as JR1csShape,
    R1csWitness as JR1csWitness,
    RelaxedR1csInstance as JRelaxed,
    RelaxedR1csWitness as JRelaxedWitness,
    r1cs_instance_and_witness as j_instance_and_witness,
)
from kogarashi_tpu.r1cs import BN254_DRIVER as JBN, GRUMPKIN_DRIVER as JGR, R1CS as JR1CS
from kogarashi_tpu.r1cs import FieldAssignment as JFA
from kogarashi_tpu.utils.serde import encode_recursive_proof as j_encode
from kogarashi_tpu.utils.xorshift import XorShiftRng as JXorShiftRng
from kogarashi_tpu_torch import constants as C
from kogarashi_tpu_torch import interop
from kogarashi_tpu_torch.nova import R1CS_COUNTS, ExampleFunction, Ivc, PublicParams, reset_r1cs_counts
from kogarashi_tpu_torch.nova.augmented import AugmentedFCircuit
from kogarashi_tpu_torch.nova.nifs import NifsProver, NifsVerifier
from kogarashi_tpu_torch.nova.pedersen import PedersenCommitment
from kogarashi_tpu_torch.nova.relaxed_r1cs import (
    R1csInstance,
    R1csShape,
    R1csWitness,
    RelaxedR1csInstance,
    RelaxedR1csWitness,
    r1cs_instance_and_witness,
)
from kogarashi_tpu_torch.r1cs import BN254_DRIVER, GRUMPKIN_DRIVER, R1CS, FieldAssignment, WitnessCS
from kogarashi_tpu_torch.utils.serde import encode_recursive_proof
from kogarashi_tpu_torch.utils.xorshift import REFERENCE_TEST_SEED, XorShiftRng

torch.set_num_threads(2)  # the suite runs several workers side by side

# sha256 of the JAX package's serialized 3-step RecursiveProof under the
# reference seed. tests/test_fixed_seed_ivc.py:26 pins another value, which
# the JAX package no longer gives: its test fails there, its proof verifies,
# and this is the digest that test reports.
JAX_PROOF_DIGEST = "488173b8bec07319e19a6949aaf43069f72932c78de84983e2c250d8af183f56"

DRIVERS = {"bn254": (BN254_DRIVER, JBN), "grumpkin": (GRUMPKIN_DRIVER, JGR)}


def pt(q):
    """An affine point of either package -> ints."""
    return (True,) if q.is_infinity else (False, q.x.v, q.y.v)


def relaxed(u):
    return (pt(u.commit_w), pt(u.commit_e), u.u, list(u.x))


# ---------------------------------------------------------------------------
# augmented circuits
# ---------------------------------------------------------------------------


def _jax_inputs(other, seed):
    """JAX-made inputs of step 1 for a circuit folding `other`'s (JAX
    driver) instances: points on its commitment curve, x values below
    2^250 (hashes), u and commit_t."""
    rng = random.Random(seed)
    g = other.commit_curve.generator
    point = lambda: rng.randrange(1, 1 << 250) * g  # noqa: E731
    u_single = JR1csInstance(commit_w=point(), x=[rng.randrange(1 << 250) for _ in range(2)])
    u_range = JRelaxed(driver=other, commit_w=point(), commit_e=point(),
                       u=rng.randrange(other.scalar.p), x=[rng.randrange(1 << 250) for _ in range(2)])
    return dict(z_i=[rng.randrange(1 << 250)], u_single=u_single, u_range=u_range, commit_t=point())


def _synth(pkg_driver, other, fc, Aug, R1, is_primary, i, inputs):
    cs = R1(pkg_driver)
    z = Aug(other_driver=other, fc=fc, is_primary=is_primary, i=i, z_0=[0], **inputs).generate(cs)
    return cs, [v.value(cs) for v in z]


def _step_inputs(primary, step):
    """The drivers of a side and step `step`'s inputs, JAX-made (a step-1
    instance of real points and x values) and carried over by `interop`:
    (me, other, JAX inputs, port inputs)."""
    me, other = (BN254_DRIVER, GRUMPKIN_DRIVER) if primary else (GRUMPKIN_DRIVER, BN254_DRIVER)
    jin, pin = {}, {}
    if step:
        jin = _jax_inputs(JGR if primary else JBN, 7 + primary)
        pin = dict(z_i=list(jin["z_i"]),
                   u_single=interop.instance_from_jax(other, jin["u_single"]),
                   u_range=interop.relaxed_instance_from_jax(jin["u_range"]),
                   commit_t=interop.commit_point(other, jin["commit_t"]))
    return me, other, jin, pin


_FULL = {}


def _port_full(primary, step):
    """The port's circuit of a side and step synthesized into an R1CS,
    (cs, z_next values), once per module."""
    if (primary, step) not in _FULL:
        me, other, _, pin = _step_inputs(primary, step)
        _FULL[primary, step] = _synth(me, other, ExampleFunction, AugmentedFCircuit, R1CS, primary, step, pin)
    return _FULL[primary, step]


def _same_circuit(cs, jcs):
    assert (cs.m, cs.l(), cs.m_l_1()) == (jcs.m, jcs.l(), jcs.m_l_1())
    assert cs.x == jcs.x and cs.w == jcs.w
    for (r, c, v), (jr, jc, jv) in zip(cs.matrices_coo(), jcs.matrices_coo()):
        assert r.tolist() == jr.tolist() and c.tolist() == jc.tolist()
        assert [int(a) for a in v] == [int(a) for a in jv]


@pytest.mark.parametrize("primary", [True, False], ids=["primary", "secondary"])
@pytest.mark.parametrize("step", [0, 1])
def test_augmented_circuit_matches_jax(primary, step):
    """Step 0 (the base case) and step 1 fed the same JAX-made instances
    through `interop`: the same m, l, m_l_1, A/B/C triples, public inputs,
    witness and z_next (about 1 s of synthesis per package)."""
    jme, jother = (JBN, JGR) if primary else (JGR, JBN)
    _, _, jin, _ = _step_inputs(primary, step)
    cs, z = _port_full(primary, step)
    jcs, jz = _synth(jme, jother, JExampleFunction, JAugmented, JR1CS, primary, step, jin)
    _same_circuit(cs, jcs)
    assert z == jz
    if not step:  # the sizes PublicParams.setup freezes
        assert (cs.m, cs.m_l_1()) == ((76934, 64230) if primary else (78982, 66284))


@pytest.mark.parametrize("primary", [True, False], ids=["primary", "secondary"])
@pytest.mark.parametrize("step", [0, 1])
def test_witness_only_synthesis_matches_full(primary, step):
    """The same circuit and inputs synthesized into a WitnessCS (what `Ivc`
    and `prove_step` do) and into an R1CS (what `PublicParams.setup` does):
    the same m, l, m_l_1, public inputs, witness and z_next, element for
    element, at the base case and at step 1."""
    me, other, _, pin = _step_inputs(primary, step)
    cs, z = _port_full(primary, step)
    ws, wz = _synth(me, other, ExampleFunction, AugmentedFCircuit, WitnessCS, primary, step, pin)
    assert (ws.m, ws.l(), ws.m_l_1()) == (cs.m, cs.l(), cs.m_l_1())
    assert ws.x == cs.x and ws.w == cs.w and wz == z


# ---------------------------------------------------------------------------
# Pedersen keys
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["bn254", "grumpkin"])
def test_pedersen_keys_random_match_jax(name):
    """random.Random: host x-rejection sampling gives the JAX package's
    points, and the device rows decode to them."""
    driver, jdriver = DRIVERS[name]
    ck = PedersenCommitment(driver.commit_curve, 4, random.Random(5), active=11, device="cpu")
    jck = JPedersen(jdriver.commit_curve, 4, random.Random(5), active=11)
    assert [pt(q) for q in ck.g] == [pt(q) for q in jck.g]
    ck._g_list = None
    assert [pt(q) for q in ck.g] == [pt(q) for q in jck.g]


@pytest.mark.parametrize("name", ["bn254", "grumpkin"])
def test_pedersen_keys_xorshift_match_jax(name):
    """XorShiftRng: the reference stream (generator * field_random(order),
    all 2^k + 1 scalars drawn) through the device fixed-base multiply and
    to_affine gives the JAX pyref's points, and leaves the stream where the
    JAX package leaves it."""
    driver, jdriver = DRIVERS[name]
    rng = XorShiftRng.from_seed(REFERENCE_TEST_SEED)
    ck = PedersenCommitment(driver.commit_curve, 3, rng, active=6, device="cpu")
    jrng = JXorShiftRng.from_seed(REFERENCE_TEST_SEED)
    want = [jrng.point_random(jdriver.commit_curve) for _ in range(ck.key_len)][:6]
    assert [pt(q) for q in ck.g] == [pt(q) for q in want]
    assert rng.next_u64() == jrng.next_u64()


@pytest.mark.parametrize("name", ["bn254", "grumpkin"])
def test_commit_matches_commit_host(name):
    """The MSM commit (plain versions here) against the host loop, with a
    message shorter than the key and values near the scalar modulus."""
    driver, _ = DRIVERS[name]
    ck = PedersenCommitment(driver.commit_curve, 3, random.Random(6), device="cpu")
    p = driver.scalar.p
    m = [p - 1, 0, 1, p - 2, random.Random(7).randrange(p)]
    assert ck.commit(m) == ck.commit_host(m)
    assert ck.commit([]) == driver.commit_curve.identity_affine()
    with pytest.raises(ValueError):
        ck.commit([1] * (ck.n_active + 1))


# ---------------------------------------------------------------------------
# NIFS, with the same keys in both packages
# ---------------------------------------------------------------------------


def example_r1cs(FA, R1, driver, x_val: int):
    """x^3 + x + 5 = o over the driver's scalar field (tests/test_nova_nifs.py:19)."""
    p = driver.scalar.p
    cs = R1(driver)
    o_val = (x_val**3 + x_val + 5) % p
    x = FA.instance(cs, x_val)
    o = FA.instance(cs, o_val)
    c5 = FA.constant(cs, 5)
    sym1 = FA.mul(cs, x, x)
    y = FA.mul(cs, sym1, x)
    sym2 = FA.add(cs, y, x)
    FA.enforce_eq(cs, sym2 + c5, o)
    return cs


def _jax_key(jdriver, shape, seed):
    """The JAX package's key; it commits through commit_host here, so no
    MSM is compiled."""
    k = max((shape.m - 1).bit_length(), 1)
    ck = JPedersen(jdriver.commit_curve, k, random.Random(seed))
    ck.commit = ck.commit_host
    return ck


def test_nifs_matches_jax():
    """One fold of example_r1cs(3) into example_r1cs(4) over both drivers:
    the JAX package's public parameters (shapes, keys, step functions)
    through `interop.public_params_from_jax`, then the same folded instance,
    witness and commit_t from both packages; the verifier's fold agrees and
    the folded pair satisfies the relaxed shape."""
    jshapes, jkeys = {}, {}
    for name, (_, jdriver) in DRIVERS.items():
        jshapes[name] = JR1csShape.from_r1cs(example_r1cs(JFA, JR1CS, jdriver, 4))
        jkeys[name] = _jax_key(jdriver, jshapes[name], 11 + len(name))
    jpp = JPublicParams(jshapes["bn254"], jshapes["grumpkin"], jkeys["bn254"], jkeys["grumpkin"],
                        JExampleFunction, JExampleFunction)
    pp = interop.public_params_from_jax(jpp, device="cpu")
    assert pp.fc_primary is ExampleFunction and pp.fc_secondary is ExampleFunction
    for name, shape, ck in (("bn254", pp.shape_primary, pp.ck_primary),
                            ("grumpkin", pp.shape_secondary, pp.ck_secondary)):
        driver, jdriver = DRIVERS[name]
        jshape, jck = jshapes[name], jkeys[name]
        assert (shape.m, shape.l(), shape.m_l_1()) == (jshape.m, jshape.l(), jshape.m_l_1())
        assert [pt(q) for q in ck.g] == [pt(q) for q in jck.g]

        x1, w1 = r1cs_instance_and_witness(example_r1cs(FieldAssignment, R1CS, driver, 4), shape, ck)
        i1 = RelaxedR1csInstance.from_r1cs_instance(driver, x1)
        wt1 = RelaxedR1csWitness.from_r1cs_witness(shape, w1)
        i2, wt2 = r1cs_instance_and_witness(example_r1cs(FieldAssignment, R1CS, driver, 3), shape, ck)
        fi, fw, ct = NifsProver(shape, ck).prove(i1, wt1, i2, wt2)

        jx1, jw1 = j_instance_and_witness(example_r1cs(JFA, JR1CS, jdriver, 4), jshape, jck)
        ji1 = JRelaxed.from_r1cs_instance(jdriver, jx1)
        jwt1 = JRelaxedWitness.from_r1cs_witness(jshape, jw1)
        ji2, jwt2 = j_instance_and_witness(example_r1cs(JFA, JR1CS, jdriver, 3), jshape, jck)
        jfi, jfw, jct = JNifsProver(jshape, jck).prove(ji1, jwt1, ji2, jwt2)

        assert pt(x1.commit_w) == pt(jx1.commit_w) and pt(i2.commit_w) == pt(ji2.commit_w)
        assert pt(ct) == pt(jct)
        assert relaxed(fi) == relaxed(jfi)
        assert (fw.w, fw.e) == (jfw.w, jfw.e)
        assert relaxed(NifsVerifier.verify(ct, i1, i2)) == relaxed(JNifsVerifier.verify(jct, ji1, ji2))
        assert shape.is_sat_relaxed(fi, fw) and shape.is_sat(ck, i2, wt2)
        fw.e[0] = (fw.e[0] + 1) % shape.p
        assert not shape.is_sat_relaxed(fi, fw)


def _int_products(shape, u, x, w):
    """(A z, B z, C z) in plain ints from the shape's own rows, z = [u | x | w]."""
    z, l, p = [u, *x, *w], len(x) + 1, shape.p
    return [[sum(int(c) * z[k if kind == "x" else k + l] for (kind, k), c in row.terms.items()) % p
             for row in rows] for rows in (shape.a, shape.b, shape.c)]


@pytest.mark.parametrize("name", ["bn254", "grumpkin"])
def test_cross_term_and_relaxed_check_match_ints(name):
    """R1csShape.cross_term and is_sat_relaxed, their field values converted
    on the device, against plain ints over the shape's own rows
    (example_r1cs, Fr and Fq): 0, 1 and p - 1 in x and W, u1 outside {0, 1};
    a W value in [p, 2^256) gives its reduction's T with nothing reduced on
    the host, a negative one is reduced there and counted. R1CS_COUNTS: one
    cross term, its z1, z2, u1 and T converted on the device."""
    driver = DRIVERS[name][0]
    shape = R1csShape.from_r1cs(example_r1cs(FieldAssignment, R1CS, driver, 4), device="cpu")
    p, m, rng = shape.p, shape.m, random.Random(19)
    assert (shape.l(), shape.m_l_1()) == (2, 3)
    u1, x1, w1 = rng.randrange(2, p), [p - 1, 0], [1, p - 1, rng.randrange(p)]
    x2, w2 = [1, p - 1], [0, rng.randrange(p), 1]
    ident = driver.commit_curve.identity_affine()
    i2, wt2 = R1csInstance(commit_w=ident, x=x2), R1csWitness(w=w2)
    a1, b1, c1 = _int_products(shape, u1, x1, w1)
    a2, b2, c2 = _int_products(shape, 1, x2, w2)
    want = [(a1[i] * b2[i] + a2[i] * b1[i] - u1 * c2[i] - c1[i]) % p for i in range(m)]
    e1 = [(a1[i] * b1[i] - u1 * c1[i]) % p for i in range(m)]

    for w, host in ((w1, 0), ([w1[0], w1[1], w1[2] + p], 0), ([w1[0], -1, w1[2]], 1)):
        i1 = RelaxedR1csInstance(driver=driver, commit_w=ident, commit_e=ident, u=u1, x=x1)
        wt1 = RelaxedR1csWitness(w=w, e=e1)
        reset_r1cs_counts()
        assert shape.cross_term(i1, wt1, i2, wt2) == want
        z_len = 1 + len(x1) + len(w)
        assert R1CS_COUNTS == {"cross_terms": 1, "device_converted": 2 * z_len + 1 + m,
                               "host_converted": host}
        reset_r1cs_counts()
        assert shape.is_sat_relaxed(i1, wt1)
        assert R1CS_COUNTS == {"cross_terms": 0, "device_converted": z_len + 1 + m,
                               "host_converted": host}
        wt1.e = [e1[0], (e1[1] + 1) % p, *e1[2:]]
        assert not shape.is_sat_relaxed(i1, wt1)
    reset_r1cs_counts()
    assert set(R1CS_COUNTS.values()) == {0}


def test_recursive_proof_from_jax_encodes_alike():
    """A JAX RecursiveProof (JAX-made instances and witnesses) through
    `interop.recursive_proof_from_jax`: the port's encoder gives the JAX
    package's bytes."""
    rng = random.Random(9)
    ins = _jax_inputs(JGR, 3)
    jr_primary = _jax_inputs(JBN, 4)["u_range"]
    w = lambda n, p: [rng.randrange(p) for _ in range(n)]  # noqa: E731
    jproof = JRecursiveProof(
        i=3, z0_primary=[0], z0_secondary=[0], zi_primary=[rng.randrange(C.R)],
        zi_secondary=[rng.randrange(C.Q)], u_single_secondary=ins["u_single"],
        w_single_secondary=JR1csWitness(w=w(5, C.Q)),
        u_range_primary=jr_primary, w_range_primary=JRelaxedWitness(w=w(5, C.R), e=w(4, C.R)),
        u_range_secondary=ins["u_range"], w_range_secondary=JRelaxedWitness(w=w(5, C.Q), e=w(4, C.Q)))
    proof = interop.recursive_proof_from_jax(jproof)
    assert encode_recursive_proof(proof) == j_encode(jproof)


# ---------------------------------------------------------------------------
# the full chain (slow on the CPU: every commit is a 77-79k-point MSM on the
# plain versions)
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_three_steps_reference_chain_digest():
    """setup -> Ivc -> 3 x prove_step under the reference seed, on the CPU:
    the proof verifies, a tampered z_i is rejected, z_i follows
    z -> z^3 + z + 5 from 0, and the serialized proof's sha256 is the JAX
    package's."""
    pp = PublicParams.setup(ExampleFunction, ExampleFunction,
                            XorShiftRng.from_seed(REFERENCE_TEST_SEED), device="cpu")
    ivc = Ivc(pp, z0_primary=[0], z0_secondary=[0])
    for _ in range(3):
        proof = ivc.prove_step()
    assert proof.verify(pp)
    z = 0
    for _ in range(proof.i):
        z = (z**3 + z + 5) % C.R
    assert proof.zi_primary == [z]
    assert hashlib.sha256(encode_recursive_proof(proof)).hexdigest() == JAX_PROOF_DIGEST
    proof.zi_primary = [(z + 1) % C.R]
    assert not proof.verify(pp)
