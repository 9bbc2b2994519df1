"""The port's RedDSA over Jubjub against the JAX package's, on the CPU: from
the same `random.Random`, the same keys, signatures and bytes; the same host
verdicts; and `batch_verify` (E1-E3's plain versions and the identity test)
giving the JAX package's `batch_verify` verdicts on the same batches, the
bad lanes of tests/test_signature.py (a flipped message, S + 1) and a lane
whose R does not decompress among them."""

import random

import pytest
import torch

from kogarashi_tpu.pyref.edwards import JUBJUB_SPEC as JSPEC
from kogarashi_tpu.signature import (
    RedDSA as JRedDSA,
    SecretKey as JSecretKey,
    Signature as JSignature,
    VerificationKey as JVerificationKey,
    batch_verify as jbatch_verify,
)
from kogarashi_tpu.signature.reddsa import hash_to_scalar as jhash_to_scalar
from kogarashi_tpu_torch.pyref import JUBJUB_SPEC, EdwardsSpec
from kogarashi_tpu_torch.signature import (
    RedDSA,
    SecretKey,
    Signature,
    VerificationKey,
    batch_verify,
    hash_to_scalar,
)

torch.set_num_threads(2)  # the suite runs several workers side by side

N = 5


def _sign_all(dsa, rng):
    pairs = [dsa.keygen(rng) for _ in range(N)]
    msgs = [f"msg-{i}".encode() for i in range(N)]
    sigs = [sk.sign(m, rng) for (sk, _), m in zip(pairs, msgs)]
    return pairs, msgs, sigs


@pytest.fixture(scope="module")
def both():
    """Five keys and signatures from random.Random(0xC0FFEE), made by each
    package."""
    return _sign_all(RedDSA(), random.Random(0xC0FFEE)), _sign_all(JRedDSA(), random.Random(0xC0FFEE))


def test_keys_and_signatures_match_jax_bytes(both):
    (pairs, msgs, sigs), (jpairs, jmsgs, jsigs) = both
    assert msgs == jmsgs
    for (sk, vk), (jsk, jvk) in zip(pairs, jpairs):
        assert sk.to_bytes() == jsk.to_bytes() and vk.to_bytes() == jvk.to_bytes()
    assert [s.to_bytes() for s in sigs] == [s.to_bytes() for s in jsigs]
    assert hash_to_scalar(JUBJUB_SPEC, b"a", b"bc") == jhash_to_scalar(JSPEC, b"a", b"bc")


def test_serde_and_host_verify_match_jax(both):
    (pairs, msgs, sigs), (jpairs, _, jsigs) = both
    sk, vk = pairs[0]
    assert len(sigs[0].to_bytes()) == Signature.LENGTH == 64
    assert len(vk.to_bytes()) == VerificationKey.LENGTH == 32
    vk2 = VerificationKey.from_bytes(JUBJUB_SPEC, vk.to_bytes())
    assert vk2.verify(msgs[0], Signature.from_bytes(sigs[0].to_bytes()))
    assert SecretKey.from_bytes(JUBJUB_SPEC, sk.to_bytes()).sk == sk.sk
    assert Signature.from_bytes(b"\x00" * 7) is None is JSignature.from_bytes(b"\x00" * 7)
    assert SecretKey.from_bytes(JUBJUB_SPEC, b"\xff" * 32) is None is JSecretKey.from_bytes(JSPEC, b"\xff" * 32)
    bad_vk = b"\xff" * 32  # y >= p: does not decompress
    assert VerificationKey.from_bytes(JUBJUB_SPEC, bad_vk) is None is JVerificationKey.from_bytes(JSPEC, bad_vk)
    for (_, v), (_, jv), s, js in zip(pairs, jpairs, sigs, jsigs):
        for m in (msgs[0], b"tampered"):
            assert v.verify(m, s) == jv.verify(m, js)
    alpha = 12345
    rsk, rvk = sk.randomize(alpha), vk.randomize(alpha)
    assert rsk.verification_key().to_bytes() == rvk.to_bytes()
    assert rvk.verify(b"r", rsk.sign(b"r", random.Random(1)))


def _bad_batch(msgs, sigs, sig_cls, order):
    """tests/test_signature.py:63-75: lane 1 has S + 1, lane 2 a changed
    message; and lane 3 R bytes that do not decompress."""
    bad = list(sigs)
    bad[1] = sig_cls(sigs[1].r_bytes, (sigs[1].s + 1) % order)
    bad[3] = sig_cls(b"\xff" * 32, sigs[3].s)
    return [msgs[0], msgs[1], b"x", msgs[3], msgs[4]], bad


def test_batch_verify_matches_jax(both):
    (pairs, msgs, sigs), (jpairs, jmsgs, jsigs) = both
    vks, jvks = [v for _, v in pairs], [v for _, v in jpairs]
    assert batch_verify(vks, msgs, sigs, device="cpu") == jbatch_verify(jvks, jmsgs, jsigs) == [True] * N
    bm, bs = _bad_batch(msgs, sigs, Signature, JUBJUB_SPEC.order)
    jbm, jbs = _bad_batch(jmsgs, jsigs, JSignature, JSPEC.order)
    got = batch_verify(vks, bm, bs, device="cpu")
    assert got == jbatch_verify(jvks, jbm, jbs) == [True, False, False, False, True]
    assert got == [v.verify(m, s) for v, m, s in zip(vks, bm, bs)]


def test_batch_verify_checks_its_arguments(both):
    (pairs, msgs, sigs), _ = both
    vks = [v for _, v in pairs]
    with pytest.raises(ValueError):
        batch_verify(vks[:2], msgs, sigs, device="cpu")
    with pytest.raises(ValueError):
        batch_verify(vks, msgs[:-1], sigs, device="cpu")
    g = JUBJUB_SPEC.generator
    other = EdwardsSpec("Jubjub copy", JUBJUB_SPEC.field, JUBJUB_SPEC.d, (g.x, g.y), JUBJUB_SPEC.order,
                        JUBJUB_SPEC.cofactor)  # the same curve, but not the spec the kernels are built for
    with pytest.raises(ValueError):
        batch_verify(vks, msgs, sigs, spec=other, device="cpu")
    assert batch_verify([], [], [], device="cpu") == []
