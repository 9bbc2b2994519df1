"""Field constants and host encode/decode for the port's one layout.

A field element is 8 little-endian 32-bit words, Montgomery form with
R = 2^256 (the radix of `kogarashi_tpu/fields/mont.py` and of the Rust
reference), stored limb-major as int32 tensors holding the bit pattern:
a batch of n elements is an (8, n) array. Constants come from the port's
`constants.py`.

Scalars that only feed digit extraction stay in standard form as (16, n)
16-bit limbs, the layout of the JAX package's `ints_to_limbs(...).T`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import constants as C

N_WORDS = 8
MONT_R = 1 << 256


def ints_to_words(vals) -> np.ndarray:
    """Ints in [0, 2^256) -> (8, n) int32 words (bit patterns)."""
    buf = b"".join(int(v).to_bytes(32, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u4").reshape(-1, N_WORDS).T.copy().view(np.int32)


def words_to_ints(arr) -> list[int]:
    """(8, n) words (any int dtype holding the bit pattern) -> ints."""
    a = np.ascontiguousarray(np.asarray(arr).astype(np.int64).astype(np.uint32).T)
    buf = a.astype("<u4").tobytes()
    return [int.from_bytes(buf[i : i + 32], "little") for i in range(0, len(buf), 32)]


def ints_to_limbs16(vals) -> np.ndarray:
    """Ints in [0, 2^256) -> (16, n) int32 standard-form 16-bit limbs."""
    buf = b"".join(int(v).to_bytes(32, "little") for v in vals)
    return np.ascontiguousarray(np.frombuffer(buf, dtype="<u2").reshape(-1, 16).T.astype(np.int32))


@dataclass(frozen=True)
class FieldSpec:
    """Per-field constants as plain ints."""

    name: str
    p: int
    generator: int
    s: int
    root_of_unity: int

    @property
    def inv32(self) -> int:
        """-p^-1 mod 2^32 (CIOS constant for 32-bit words)."""
        return (-pow(self.p, -1, 1 << 32)) % (1 << 32)

    @property
    def inv16(self) -> int:
        """-p^-1 mod 2^16 (CIOS constant for the plain 16-bit halves)."""
        return (-pow(self.p, -1, 1 << 16)) % (1 << 16)

    @property
    def r1(self) -> int:
        return MONT_R % self.p

    @property
    def r2(self) -> int:
        return MONT_R * MONT_R % self.p

    @property
    def r3(self) -> int:
        return pow(MONT_R, 3, self.p)

    def to_mont(self, v: int) -> int:
        return (int(v) % self.p) * MONT_R % self.p

    def encode(self, vals) -> np.ndarray:
        """Standard-form ints -> (8, n) Montgomery words."""
        return ints_to_words([self.to_mont(v) for v in vals])

    def decode(self, arr) -> list[int]:
        """(8, n) Montgomery words -> standard-form ints."""
        rinv = pow(MONT_R, -1, self.p)
        return [v * rinv % self.p for v in words_to_ints(arr)]


FR = FieldSpec("Fr", C.R, C.FR_GENERATOR, C.FR_S, C.FR_ROOT_OF_UNITY)
FQ = FieldSpec("Fq", C.Q, C.FQ_GENERATOR, C.FQ_S, C.FQ_ROOT_OF_UNITY)
# BLS12-381's scalar field, Jubjub's base field: 255 bits, so 2p < 2^256 and
# the sums `mont` forms before its one correction (< 2p) still fit 8 words
BLS_FR = FieldSpec("BlsFr", C.BLS_FR, C.BLS_FR_GENERATOR, C.BLS_FR_S, C.BLS_FR_ROOT_OF_UNITY)
