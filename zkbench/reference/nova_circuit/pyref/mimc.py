"""Pure-Python MiMC hash + Fiat-Shamir random oracle (Nova transcript).

The port's own copy of `kogarashi_tpu/pyref/mimc.py`, without its native
sponge: the fold runs as the plain loop below, which the JAX package holds
its native sponge equal to (tests/test_native.py).

Parity: nova/src/hash.rs (Mimc, MimcRO), nova/src/hash/helper.rs (BlakeHelper).

Round constants: a chained Blake2b-512 with `person=b"mimc"`; constant_i is the
digest of the state after absorbing the previous digests, wide-reduced into the
field (from_bytes_wide of the 64-byte digest).

Round function (Feistel, x^7): (xl, xr) -> ((xl + c)^7 + xr, xl); returns the
left lane after MIMC_ROUNDS=46 rounds.

Sponge squeeze: fold `acc = key(=0)`; for each absorbed scalar s:
`h = mimc(s, acc); acc = acc + s + h`. Then take the low `num_bits` bits of the
big-endian bit string reversed (i.e. the value mod 2^num_bits) reinterpreted in
the *scalar* field of the driver.
"""

from __future__ import annotations

import hashlib

from .. import constants as C


def mimc_constants(field):
    """46 chained-Blake2b round constants in `field` (a pyref PrimeField class)."""
    h = hashlib.blake2b(digest_size=64, person=b"mimc")
    out = []
    for _ in range(C.MIMC_ROUNDS):
        digest = h.digest()
        h.update(digest)
        out.append(field.from_bytes_wide(h.digest()))
    return out


class Mimc:
    def __init__(self, field):
        self.field = field
        self.constants = mimc_constants(field)

    def hash(self, xl, xr):
        for c in self.constants:
            cxl = xl + c
            ccxl = cxl.square()
            cccxl = ccxl.square()
            ccccxl = ccxl * cccxl * cxl  # cxl^7
            xl, xr = ccccxl + xr, xl
        return xl


class MimcRO:
    """Random oracle over `base_field`, squeezing into `scalar_field`."""

    def __init__(self, base_field, scalar_field):
        self.hasher = Mimc(base_field)
        self.base_field = base_field
        self.scalar_field = scalar_field
        self.state = []
        self.key = base_field.zero()

    def append(self, x):
        assert isinstance(x, self.base_field)
        self.state.append(x)

    def append_point(self, point):
        """Absorb an affine point as (x, y, is_identity ? 0 : 1)."""
        self.append(point.x)
        self.append(point.y)
        self.append(
            self.base_field.zero() if point.is_infinity else self.base_field.one()
        )

    def append_vec(self, xs):
        for x in xs:
            self.append(x)

    def squeeze(self, num_bits: int):
        acc = self.key
        for s in self.state:
            h = self.hasher.hash(s, acc)
            acc = acc + s + h
        # low num_bits of acc, reinterpreted in the scalar field
        return self.scalar_field(acc.v & ((1 << num_bits) - 1))
