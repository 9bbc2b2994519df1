"""A Groth16 verify equation for the pairing tests, on the port's pyref and
key types only (no JAX), so that the card's tests can import it too."""

import random

from kogarashi_tpu_torch import constants as C
from kogarashi_tpu_torch import pyref
from kogarashi_tpu_torch.groth16 import Proof, VerifyingKey


def trapdoor_proof(seed: int = 6):
    """A Groth16 key and proof made with the key's trapdoor: c = (ab -
    alpha beta - gamma acc) / delta, for public inputs x. (proof, x, the
    prepared key), whose verify equation's pairing product is the key's
    alpha_g1_beta_g2."""
    r, rng = C.R, random.Random(seed)
    g1, g2 = pyref.G1_SPEC.generator, pyref.G2_SPEC.generator
    alpha, beta, gamma, delta, a, b = (rng.randrange(1, r) for _ in range(6))
    ic = [rng.randrange(1, r) for _ in range(3)]
    x = [rng.randrange(r) for _ in range(2)]
    vk = VerifyingKey(alpha * g1, beta * g1, beta * g2, gamma * g2, delta * g1, delta * g2, [s * g1 for s in ic])
    acc = (ic[0] + sum(xi * s for xi, s in zip(x, ic[1:]))) % r
    c = (a * b - alpha * beta - gamma * acc) * pow(delta, -1, r) % r
    return Proof(a=a * g1, b=b * g2, c=c * g1), x, vk.prepare()


def verify_equation_pairs(seed: int = 6):
    """The equation's three pairs, and the prepared key."""
    proof, x, pvk = trapdoor_proof(seed)
    return proof.pairs(pvk, x), pvk
