"""XorShiftRng port — bit-exact replica of the reference's deterministic RNG.

The port's own copy of `kogarashi_tpu/utils/xorshift.py`.

Parity: the `fullcodec_rand_xorshift` crate used by the reference's only
deterministic protocol test (pallet/nova/src/tests.rs:69-74: FullcodecRng ==
rand_xorshift::XorShiftRng 0.2) and the reference's randomness plumbing:

  * `next_u32`: Marsaglia xorshift128 — t = x ^ (x << 11);
    x,y,z <- y,z,w; w <- w ^ (w >> 19) ^ t ^ (t >> 8).
  * `from_seed([u8;16])`: four little-endian u32 words (all-zero seed maps
    to 0xBAD5EED per rand_xorshift).
  * `next_u64`: lo = next_u32, hi = next_u32 (lo | hi << 64-bit).
  * field sampling (`field_random`): eight next_u64 words interpreted as a
    little-endian 512-bit integer reduced mod p — the value semantics of
    `random_limbs`/`from_u512` (zkstd/src/arithmetic/limbs/bits_256/
    represent.rs:18-29, 80-107).
  * point sampling (`point_random`): generator * scalar-field sample
    (zkstd/src/macros/curve/weierstrass/group.rs:39-41).
"""

from __future__ import annotations

from ..constants import Q, R

MASK32 = 0xFFFFFFFF

# Seed used by the reference's three_steps_ivc test (tests.rs:69-74).
REFERENCE_TEST_SEED = bytes(
    [0x59, 0x62, 0xBE, 0x5D, 0x76, 0x3D, 0x31, 0x8D,
     0x17, 0xDB, 0x37, 0x32, 0x54, 0x06, 0xBC, 0xE5]
)


class XorShiftRng:
    def __init__(self, x: int, y: int, z: int, w: int):
        self.x, self.y, self.z, self.w = (v & MASK32 for v in (x, y, z, w))

    @classmethod
    def from_seed(cls, seed: bytes) -> "XorShiftRng":
        assert len(seed) == 16
        words = [int.from_bytes(seed[4 * i : 4 * i + 4], "little") for i in range(4)]
        if all(w == 0 for w in words):
            words = [0x0BAD5EED] * 4
        return cls(*words)

    def next_u32(self) -> int:
        x = self.x
        t = (x ^ (x << 11)) & MASK32
        self.x, self.y, self.z = self.y, self.z, self.w
        w = self.w
        self.w = (w ^ (w >> 19) ^ t ^ (t >> 8)) & MASK32
        return self.w

    def next_u64(self) -> int:
        lo = self.next_u32()
        hi = self.next_u32()
        return lo | (hi << 32)

    def fill_bytes(self, n: int) -> bytes:
        """Little-endian u32 stream truncated to n bytes (rand_core's
        fill_bytes_via_next for a u32 generator)."""
        out = bytearray()
        while len(out) < n:
            out += self.next_u32().to_bytes(4, "little")
        return bytes(out[:n])

    # -- reference value-sampling semantics --------------------------------
    def field_random(self, p: int) -> int:
        """random_limbs/from_u512: 512-bit LE sample reduced mod p."""
        v = 0
        for i in range(8):
            v |= self.next_u64() << (64 * i)
        return v % p

    def point_random(self, spec):
        """generator * scalar sample (weierstrass/group.rs:39-41).
        `spec` is a pyref CurveSpec; its scalar order is the *other* BN254
        field (G1 scalars are Fr, Grumpkin scalars are Fq)."""
        order = {"G1": R, "Grumpkin": Q, "G2": R}[spec.name]
        return self.field_random(order) * spec.generator
