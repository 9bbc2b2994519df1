"""The port's device pairing (kogarashi_tpu_torch.ops.pairing) on the CPU,
where P1-P3 run their plain versions: the fold flags and line coefficients
against the JAX package's (`kogarashi_tpu/ops/pairing.py`), the Miller
loop on 1 and 3 pairs and on a set with identity pairs against
`pyref.pairing_fast.multi_miller_loop`, the final exponentiation against
`final_exp_fast`, a small Groth16 proof's verify equation, `fq12_from_jax`,
and, marked slow, `pairing_device` against the JAX package's. The tower
ops are held to the JAX package's in tests/test_torch_pairing_tower.py. Every
comparison is exact. Values cross between the packages as ints: their pyref
classes never compare equal."""

import random

import numpy as np
import pytest
import torch

from kogarashi_tpu import pyref as jpyref
from kogarashi_tpu.ops import pairing as jp
from kogarashi_tpu.pyref import pairing_fast as jpf
from kogarashi_tpu_torch import constants as C
from kogarashi_tpu_torch import interop, pyref
from kogarashi_tpu_torch.groth16 import Proof, VerifyingKey
from kogarashi_tpu_torch.ops import pairing as P
from kogarashi_tpu_torch.pyref import Fq, Fq12
from kogarashi_tpu_torch.pyref.pairing_fast import G2Prepared, final_exp_fast, multi_miller_loop

torch.set_num_threads(2)  # the suite runs several workers side by side


def ints12(x):
    """An Fq12 of either package -> its 12 ints."""
    return [v.v for v in x.to_fq_list()]


def jax_fq12(x):
    return jpyref.Fq12.from_fq_list([jpyref.Fq(v) for v in ints12(x)])


def rand_fq12s(seed, n):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % C.Q for _ in range(12 * n)]
    return [Fq12.from_fq_list([Fq(v) for v in vals[12 * i: 12 * i + 12]]) for i in range(n)]


def _pairs(pkg, ks):
    """[(a G1, G2Prepared(b G2))] of either package's pyref."""
    g1, g2 = pkg.G1_SPEC.generator, pkg.G2_SPEC.generator
    prep = pyref.pairing_fast.G2Prepared if pkg is pyref else jpf.G2Prepared
    return [(a * g1, prep.from_affine(b * g2)) for a, b in ks]


def test_fold_flags_and_prepared_match_jax():
    """_FOLD_FLAGS is the JAX package's; _encode_prepared's line
    coefficients (c0 scaled by p.y, c1 by p.x) are its words, carried over
    from its 16-bit limbs, for the same two pairs."""
    assert np.array_equal(P._FOLD_FLAGS, jp._FOLD_FLAGS)
    assert P.N_FOLDS == 91 and P.N_SQUARES == 63
    ks = [(3, 5), (7, 11)]
    coeffs = P._encode_prepared(_pairs(pyref, ks), "cpu").numpy()
    for k, jc in enumerate(jp._encode_prepared(_pairs(jpyref, ks))):
        limbs = np.moveaxis(np.asarray(jc), 3, 0)  # (16, n_folds, n_pairs, 2)
        words = np.moveaxis(interop.words_from_limbs16(limbs), 0, 3)  # (n_folds, n_pairs, 2, 8)
        assert np.array_equal(coeffs[:, :, k].reshape(words.shape), words)


@pytest.fixture(scope="module")
def groth16():
    """A Groth16 key and proof made with the key's trapdoor: c = (ab -
    alpha beta - gamma acc) / delta, for public inputs x; its prepared key."""
    r, rng = C.R, random.Random(6)
    g1, g2 = pyref.G1_SPEC.generator, pyref.G2_SPEC.generator
    alpha, beta, gamma, delta, a, b = (rng.randrange(1, r) for _ in range(6))
    ic = [rng.randrange(1, r) for _ in range(3)]
    x = [rng.randrange(r) for _ in range(2)]
    vk = VerifyingKey(alpha * g1, beta * g1, beta * g2, gamma * g2, delta * g1, delta * g2, [s * g1 for s in ic])
    acc = (ic[0] + sum(xi * s for xi, s in zip(x, ic[1:]))) % r
    c = (a * b - alpha * beta - gamma * acc) * pow(delta, -1, r) % r
    return Proof(a=a * g1, b=b * g2, c=c * g1), x, vk.prepare()


@pytest.fixture(scope="module")
def three_pairs(groth16):
    proof, x, pvk = groth16
    pairs = proof.pairs(pvk, x)
    return pairs, P.multi_miller_loop_device(pairs, "cpu")


def test_miller_loop_three_pairs(three_pairs):
    """The verify equation's three pairs through P1's plain version: the
    pyref multi_miller_loop, exactly."""
    pairs, ml = three_pairs
    assert ml.shape == (96,) and ml.dtype == torch.int32
    assert P.decode_fq12(ml) == multi_miller_loop(pairs)


def test_final_exp_and_verify_equation(groth16, three_pairs):
    """P2's plain version on the three-pair Miller loop: final_exp_fast's
    value, which is the key's alpha_g1_beta_g2 (the equation holds), and
    Gt's check (P3's plain version) says so, and not for another target."""
    _, _, pvk = groth16
    pairs, ml = three_pairs
    fe = P.final_exp_device(ml)
    assert P.decode_fq12(fe) == final_exp_fast(multi_miller_loop(pairs)) == pvk.alpha_g1_beta_g2
    assert P.gt_eq_device(fe, pvk.alpha_g1_beta_g2)
    assert not P.gt_eq_device(fe, pvk.alpha_g1_beta_g2.square())


def test_miller_loop_one_pair_and_identity_pairs():
    """One pair, then the same pair among identity pairs (P or Q at
    infinity, which the loop skips), then identity pairs only (one)."""
    g1, g2 = pyref.G1_SPEC.generator, pyref.G2_SPEC.generator
    live = (9 * g1, G2Prepared.from_affine(10 * g2))
    ml = P.multi_miller_loop_device([live], "cpu")
    assert P.decode_fq12(ml) == multi_miller_loop([live])
    inf1 = pyref.G1_SPEC.identity_affine()
    inf2 = G2Prepared.from_affine(pyref.G2_SPEC.identity_affine())
    mixed = [(inf1, G2Prepared.from_affine(g2)), live, (4 * g1, inf2)]
    assert torch.equal(P.multi_miller_loop_device(mixed, "cpu"), ml)
    assert P.decode_fq12(ml) == multi_miller_loop(mixed)
    none = P.multi_miller_loop_device([(inf1, inf2), (g1, inf2)], "cpu")
    assert P.decode_fq12(none) == Fq12.one() == multi_miller_loop([(inf1, inf2)])


def test_fq12_from_jax_round_trips():
    """A JAX device Fq12, one and batched (2, 3, 2, 16, n), carried into the
    port's layout: the port's own encoding of the same values, which
    decodes to them."""
    xs = rand_fq12s(4, 3)
    one = interop.fq12_from_jax(np.asarray(jp.encode_fq12(jax_fq12(xs[0]))), device="cpu")
    assert torch.equal(one, P.encode_fq12(xs[0], "cpu")) and P.decode_fq12(one) == xs[0]
    batch = np.stack([np.asarray(jp.encode_fq12(jax_fq12(x))) for x in xs], axis=-1)
    many = interop.fq12_from_jax(batch, device="cpu")
    assert many.shape == (96, 3) and P.decode_fq12(many) == xs
    with pytest.raises(ValueError):
        interop.fq12_from_jax(np.zeros((2, 3, 2, 8), np.uint32), device="cpu")


@pytest.mark.slow
def test_pairing_device_matches_jax():
    """pairing_device(a G1, G2) on both packages' device paths (the port's
    plain P1 and P2, the JAX package's XLA scans): the same Fq12."""
    a = random.Random(7).randrange(1, 1 << 32)
    got = P.pairing_device(a * pyref.G1_SPEC.generator, pyref.G2_SPEC.generator, "cpu")
    want = jp.decode_fq12(jp.pairing_device(a * jpyref.G1_SPEC.generator, jpyref.G2_SPEC.generator))
    assert ints12(P.decode_fq12(got)) == ints12(want)
