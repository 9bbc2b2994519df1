"""Field constants and host encode/decode for the port's one layout.

A field element is 8 little-endian 32-bit words, Montgomery form with
R = 2^256 (the radix of `kogarashi_tpu/fields/mont.py` and of the Rust
reference), stored limb-major as int32 tensors holding the bit pattern:
a batch of n elements is an (8, n) array. The width is the spec's
`n_words`: 8 for every field the kernels run, 12 (R = 2^384) for
BLS12-381's base field, which only the plain engine (`fields/mont.py`) runs,
as the JAX package's 24-limb `BLS_FQ` has no kernel behind it. Constants come
from the port's `constants.py`.

Scalars that only feed digit extraction stay in standard form as (16, n)
16-bit limbs, the layout of the JAX package's `ints_to_limbs(...).T`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import constants as C

N_WORDS = 8
MONT_R = 1 << 256


def ints_to_words(vals, n_words: int = N_WORDS) -> np.ndarray:
    """Ints in [0, 2^(32 n_words)) -> (n_words, n) int32 words (bit patterns)."""
    buf = b"".join(int(v).to_bytes(4 * n_words, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u4").reshape(-1, n_words).T.copy().view(np.int32)


def words_to_ints(arr) -> list[int]:
    """(n_words, n) words (any int dtype holding the bit pattern) -> ints."""
    a = np.asarray(arr)
    width = 4 * a.shape[0]
    buf = np.ascontiguousarray(a.astype(np.int64).astype(np.uint32).T).astype("<u4").tobytes()
    return [int.from_bytes(buf[i : i + width], "little") for i in range(0, len(buf), width)]


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
    n_words: int = N_WORDS

    @property
    def mont_r(self) -> int:
        """The Montgomery radix R = 2^(32 n_words)."""
        return 1 << (32 * self.n_words)

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
        return self.mont_r % self.p

    @property
    def r2(self) -> int:
        return self.mont_r * self.mont_r % self.p

    @property
    def r3(self) -> int:
        return pow(self.mont_r, 3, self.p)

    def to_mont(self, v: int) -> int:
        return (int(v) % self.p) * self.mont_r % self.p

    def encode(self, vals) -> np.ndarray:
        """Standard-form ints -> (n_words, n) Montgomery words."""
        return ints_to_words([self.to_mont(v) for v in vals], self.n_words)

    def decode(self, arr) -> list[int]:
        """(n_words, n) Montgomery words -> standard-form ints."""
        rinv = pow(self.mont_r, -1, self.p)
        return [v * rinv % self.p for v in words_to_ints(arr)]


FR = FieldSpec("Fr", C.R, C.FR_GENERATOR, C.FR_S, C.FR_ROOT_OF_UNITY)
FQ = FieldSpec("Fq", C.Q, C.FQ_GENERATOR, C.FQ_S, C.FQ_ROOT_OF_UNITY)
# BLS12-381's scalar field, Jubjub's base field: 255 bits, so 2p < 2^256 and
# the sums `mont` forms before its one correction (< 2p) still fit 8 words
BLS_FR = FieldSpec("BlsFr", C.BLS_FR, C.BLS_FR_GENERATOR, C.BLS_FR_S, C.BLS_FR_ROOT_OF_UNITY)
# BLS12-381's base field at 12 words, R = 2^384 (the JAX package's 24-limb
# `BLS_FQ`, kogarashi_tpu/fields/spec.py:118): q = 3 mod 4, so S = 1, the
# generator 2 and the root of unity -1; 2q < 2^384
BLS_FQ = FieldSpec("BlsFq", C.BLS_FQ, 2, 1, C.BLS_FQ - 1, n_words=12)
