"""The port's proof serialization and pallet against the JAX package's, on
the CPU: round trips; the same bytes from the dummy recursive proof of
tests/test_serde_pallet.py and from a Groth16 proof; each package decoding
the other's bytes; the same exceptions on off-curve, non-canonical and
non-subgroup inputs; and the pallet's dispatch and events."""

import random

import pytest

from kogarashi_tpu import errors as jerrors
from kogarashi_tpu import pyref as jpyref
from kogarashi_tpu.groth16.keys import Proof as JProof
from kogarashi_tpu.nova.proof import RecursiveProof as JRecursiveProof
from kogarashi_tpu.nova.relaxed_r1cs import (
    R1csInstance as JR1csInstance,
    R1csWitness as JR1csWitness,
    RelaxedR1csInstance as JRelaxedR1csInstance,
    RelaxedR1csWitness as JRelaxedR1csWitness,
)
from kogarashi_tpu.pallet import NovaPallet as JNovaPallet, SamplePallet as JSamplePallet
from kogarashi_tpu.r1cs import BN254_DRIVER as JBN254, GRUMPKIN_DRIVER as JGRUMPKIN
from kogarashi_tpu.utils import serde as jserde
from kogarashi_tpu_torch import constants as C
from kogarashi_tpu_torch import errors, pyref
from kogarashi_tpu_torch.groth16 import Proof
from kogarashi_tpu_torch.nova import (
    R1csInstance,
    R1csWitness,
    RecursiveProof,
    RelaxedR1csInstance,
    RelaxedR1csWitness,
)
from kogarashi_tpu_torch.pallet import NovaPallet, SamplePallet
from kogarashi_tpu_torch.r1cs import BN254_DRIVER, GRUMPKIN_DRIVER
from kogarashi_tpu_torch.utils import serde


def _dummy_proof(rng, pkg):
    """tests/test_serde_pallet.py:27, built from either package's classes."""
    if pkg == "port":
        classes = (RecursiveProof, R1csInstance, R1csWitness, RelaxedR1csInstance, RelaxedR1csWitness,
                   BN254_DRIVER, GRUMPKIN_DRIVER, pyref)
    else:
        classes = (JRecursiveProof, JR1csInstance, JR1csWitness, JRelaxedR1csInstance, JRelaxedR1csWitness,
                   JBN254, JGRUMPKIN, jpyref)
    Rp, Ri, Rw, RRi, RRw, e1, e2, pr = classes
    g1, gg = pr.G1_SPEC.generator, pr.GRUMPKIN_SPEC.generator
    return Rp(
        i=3,
        z0_primary=[0],
        z0_secondary=[0],
        zi_primary=[rng.randrange(C.R)],
        zi_secondary=[rng.randrange(C.Q)],
        u_single_secondary=Ri(commit_w=rng.randrange(C.R) * gg, x=[rng.randrange(C.Q), 1]),
        w_single_secondary=Rw(w=[rng.randrange(C.Q) for _ in range(4)]),
        u_range_primary=RRi(driver=e1, commit_w=rng.randrange(C.R) * g1, commit_e=rng.randrange(C.R) * g1,
                            u=rng.randrange(C.R), x=[rng.randrange(C.R), 2]),
        w_range_primary=RRw(w=[rng.randrange(C.R) for _ in range(4)], e=[rng.randrange(C.R)] * 3),
        u_range_secondary=RRi.dummy(e2, 2),
        w_range_secondary=RRw.dummy(4, 3),
    )


@pytest.fixture(scope="module")
def proofs():
    return _dummy_proof(random.Random(0xC0FFEE), "port"), _dummy_proof(random.Random(0xC0FFEE), "jax")


def test_recursive_proof_bytes_and_round_trip(proofs):
    proof, jproof = proofs
    data = serde.encode_recursive_proof(proof)
    assert data == jserde.encode_recursive_proof(jproof)
    back = serde.decode_recursive_proof(data)
    assert isinstance(back, RecursiveProof)
    assert back.u_range_primary.driver is BN254_DRIVER and back.u_range_secondary.driver is GRUMPKIN_DRIVER
    assert back.zi_primary == proof.zi_primary and back.u_range_primary.u == proof.u_range_primary.u
    assert back.u_range_primary.commit_e == proof.u_range_primary.commit_e
    assert back.u_range_secondary.commit_w.is_infinity
    assert serde.encode_recursive_proof(back) == data
    assert jserde.encode_recursive_proof(jserde.decode_recursive_proof(data)) == data


def test_codec_round_trips():
    for n in [0, 1, 63, 64, 16383, 16384, (1 << 30) - 1, 1 << 30, 1 << 40, 1 << 70]:
        assert serde.Decoder(serde.Codec().compact(n).bytes()).compact() == n
    rng = random.Random(4)
    v = rng.randrange(C.Q)
    pt = rng.randrange(C.R) * pyref.G1_SPEC.generator
    c = serde.Codec().field(v, C.Q).point(pt).point(pyref.G1_SPEC.identity_affine())
    d = serde.Decoder(c.bytes())
    assert d.field(C.Q) == v and d.point(pyref.G1_SPEC) == pt and d.point(pyref.G1_SPEC).is_infinity
    with pytest.raises(errors.DecodeError):
        serde.Decoder(c.bytes()[:20]).field(C.Q)


def _g2_sqrt(a, Fq, Fq2):
    """sqrt in Fq[u]/(u^2 + 1) by the norm, or None."""
    if a.is_zero():
        return Fq2.new(0, 0)
    s = (a.c0 * a.c0 + a.c1 * a.c1).sqrt()
    if s is None:
        return None
    two_inv = Fq(pow(2, -1, C.Q))
    for sign in (s, -s):
        x0 = ((a.c0 + sign) * two_inv).sqrt()
        if x0 is None or x0.v == 0:
            continue
        cand = Fq2(x0, a.c1 * two_inv * x0.invert())
        if cand * cand == a:
            return cand
    return None


def _twist_point(rng, pr):
    """An on-curve point of E'(Fq2), almost surely outside the r-order subgroup."""
    while True:
        x = pr.Fq2.new(rng.randrange(C.Q), rng.randrange(C.Q))
        y = _g2_sqrt(x * x * x + pr.G2_SPEC.b, pr.Fq, pr.Fq2)
        if y is not None:
            return pr.AffinePoint(pr.G2_SPEC, x, y, False)


def _groth16_pair(rng):
    """The same proof in both packages: A, C on G1, B on G2."""
    a, b, c = (rng.randrange(C.R) for _ in range(3))
    return (Proof(a=a * pyref.G1_SPEC.generator, b=b * pyref.G2_SPEC.generator, c=c * pyref.G1_SPEC.generator),
            JProof(a=a * jpyref.G1_SPEC.generator, b=b * jpyref.G2_SPEC.generator, c=c * jpyref.G1_SPEC.generator))


def test_groth16_proof_bytes_and_round_trip():
    proof, jproof = _groth16_pair(random.Random(5))
    data = serde.encode_groth16_proof(proof)
    assert data == jserde.encode_groth16_proof(jproof)
    back = serde.decode_groth16_proof(data)
    assert isinstance(back, Proof)
    assert back.a == proof.a and back.b == proof.b and back.c == proof.c


def _raises_same(data, decode, jdecode):
    """Both decoders raise, and the same class (by name)."""
    with pytest.raises(errors.KogarashiError) as got:
        decode(data)
    with pytest.raises(jerrors.KogarashiError) as want:
        jdecode(data)
    assert type(got.value).__name__ == type(want.value).__name__
    return type(got.value).__name__


def test_decoders_reject_what_jax_rejects(proofs):
    proof, _ = proofs
    # non-canonical field bytes (q + 1) and an off-curve G1 point
    assert _raises_same((C.Q + 1).to_bytes(32, "little"), lambda b: serde.Decoder(b).field(C.Q),
                        lambda b: jserde.Decoder(b).field(C.Q)) == "DecodeError"
    off = serde.Codec().field(123, C.Q).field(456, C.Q).boolean(False).bytes()
    assert _raises_same(off, lambda b: serde.Decoder(b).point(pyref.G1_SPEC),
                        lambda b: jserde.Decoder(b).point(jpyref.G1_SPEC)) == "MalformedProof"
    # a Groth16 proof whose B is on the twist but outside the r-order subgroup
    bad_b = _twist_point(random.Random(6), pyref)
    assert bad_b.is_on_curve()
    data = serde.encode_groth16_proof(Proof(a=pyref.G1_SPEC.generator, b=bad_b, c=pyref.G1_SPEC.generator))
    assert _raises_same(data, serde.decode_groth16_proof, jserde.decode_groth16_proof) == "MalformedProof"
    # a recursive proof with one commitment byte flipped (off the curve) or
    # one field made non-canonical
    data = bytearray(serde.encode_recursive_proof(proof))
    at = 1 + 4 * 33  # i, four one-element vectors; then u_single_secondary.commit_w's x
    data[at] ^= 1
    assert _raises_same(bytes(data), serde.decode_recursive_proof,
                        jserde.decode_recursive_proof) == "MalformedProof"
    for pallet in (NovaPallet(), JNovaPallet()):  # the pallet decodes, and raises the same
        with pytest.raises((errors.MalformedProof, jerrors.MalformedProof)):
            pallet.verify("alice", bytes(data), _UnsatPP)
        assert pallet.events == []
    data[at] ^= 1
    data[at: at + 32] = (C.R + 5).to_bytes(32, "little")
    assert _raises_same(bytes(data), serde.decode_recursive_proof,
                        jserde.decode_recursive_proof) == "DecodeError"


class _UnsatPP:
    """Public parameters whose shapes satisfy nothing; the dummy proof's
    hash checks fail before any shape is consulted."""

    class shape_primary:
        @staticmethod
        def is_sat_relaxed(i, w):
            return False


def test_pallet_dispatch_matches_jax(proofs):
    """Invalid proofs (object or bytes) are rejected with an InvalidProof
    event; the sample pallet mutates only on success."""
    proof, jproof = proofs
    data = serde.encode_recursive_proof(proof)
    pallet, jpallet = NovaPallet(), JNovaPallet()
    for p, jp in ((proof, jproof), (data, data)):
        assert pallet.verify("alice", p, _UnsatPP) == jpallet.verify("alice", jp, _UnsatPP) is False
    assert pallet.events == jpallet.events == [("InvalidProof", "alice")] * 2
    sample, jsample = SamplePallet(), JSamplePallet()
    assert sample.set_thing_1("bob", 42, data, _UnsatPP) == jsample.set_thing_1("bob", 42, data, _UnsatPP) is False
    assert sample.thing == jsample.thing == 0

    class AcceptAll:
        @staticmethod
        def verify(pp):
            return True

    assert sample.set_thing_1("bob", 42, AcceptAll, None)
    assert sample.thing == 42 and sample.events == [("ThingSet", "bob", 42)]
    assert sample.nova.events[-1] == ("ProofVerified", "bob")
