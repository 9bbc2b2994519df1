"""Pure-Python (bigint) prime-field reference.

The port's own copy of `kogarashi_tpu/pyref/field.py` (Fr, Fq and BlsFq). Its
classes are not the JAX package's: an element of one never equals an element
of the other, so tests that hold the two packages side by side compare ints.

This is the *oracle* the kernels are tested against bit-for-bit. It mirrors
the observable semantics of the reference's field layer
(zkstd/src/arithmetic/limbs/bits_256/, bn254/src/{fr,fq}.rs) — canonical values
in [0, p), little-endian 32-byte serialization, big-endian bit decomposition,
64-byte wide reduction — without any Montgomery representation (values are
plain ints; Montgomery is an encoding detail of the fast path).
"""

from __future__ import annotations

from .. import constants as C


class PrimeFieldMeta(type):
    def __repr__(cls):
        return cls.__name__


class PrimeField(metaclass=PrimeFieldMeta):
    """Subclass with `p`, `generator`, `s`, `t`, `root_of_unity` set."""

    p: int = 0
    generator: int = 0
    s: int = 0
    t: int = 0
    root_of_unity: int = 0
    n_bytes: int = 32  # serialized width: 32 for bits_256 fields, 48 for bits_384

    __slots__ = ("v",)

    def __init__(self, v: int = 0):
        self.v = v % self.p

    # -- basic ring ops ----------------------------------------------------
    def __add__(self, o):
        return type(self)(self.v + o.v)

    def __sub__(self, o):
        return type(self)(self.v - o.v)

    def __neg__(self):
        return type(self)(-self.v)

    def __mul__(self, o):
        return type(self)(self.v * o.v)

    def __pow__(self, e: int):
        return type(self)(pow(self.v, e, self.p))

    def __eq__(self, o):
        return type(self) is type(o) and self.v == o.v

    def __hash__(self):
        return hash((type(self).__name__, self.v))

    def __repr__(self):
        return f"{type(self).__name__}(0x{self.v:x})"

    def double(self):
        return type(self)(2 * self.v)

    def square(self):
        return type(self)(self.v * self.v)

    def invert(self):
        if self.v == 0:
            return None
        return type(self)(pow(self.v, -1, self.p))

    def is_zero(self) -> bool:
        return self.v == 0

    # -- constructors ------------------------------------------------------
    @classmethod
    def zero(cls):
        return cls(0)

    @classmethod
    def one(cls):
        return cls(1)

    @classmethod
    def from_u64(cls, v: int):
        return cls(v)

    @classmethod
    def random(cls, rng):
        return cls(rng.randrange(cls.p))

    # -- serialization (parity: bn254/src/fr.rs:73-120 SigUtils<32>) -------
    def to_bytes(self) -> bytes:
        return self.v.to_bytes(self.n_bytes, "little")

    @classmethod
    def from_bytes(cls, b: bytes):
        if len(b) != cls.n_bytes:  # fixed-width SigUtils<L> contract
            return None
        v = int.from_bytes(b, "little")
        if v >= cls.p:
            return None
        return cls(v)

    @classmethod
    def from_bytes_wide(cls, b: bytes):
        """2x-width little-endian wide reduction (zkstd from_u512)."""
        assert len(b) == 2 * cls.n_bytes
        return cls(int.from_bytes(b, "little"))

    # -- bit decompositions (parity: zkstd to_bits = big-endian 256 bits) --
    def to_bits(self) -> list[int]:
        n = 8 * self.n_bytes
        return [(self.v >> (n - 1 - i)) & 1 for i in range(n)]

    # -- sqrt (Tonelli-Shanks, parity: bn254/src/fr.rs:165) ----------------
    def sqrt(self):
        p = self.p
        if self.v == 0:
            return type(self)(0)
        if pow(self.v, (p - 1) // 2, p) != 1:
            return None
        if p % 4 == 3:
            r = pow(self.v, (p + 1) // 4, p)
            return type(self)(r)
        m, c = self.s, pow(self.generator, self.t, p)
        tt, r = pow(self.v, self.t, p), pow(self.v, (self.t + 1) // 2, p)
        while tt != 1:
            i, tmp = 0, tt
            while tmp != 1:
                tmp = tmp * tmp % p
                i += 1
            b = pow(c, 1 << (m - i - 1), p)
            m, c = i, b * b % p
            tt, r = tt * c % p, r * b % p
        return type(self)(r)

    def pow_of_2(self, k: int):
        """2^k in the field (FftField::pow_of_2)."""
        return type(self)(pow(2, k, self.p))


class Fr(PrimeField):
    """BN254 scalar field (= Grumpkin base field). bn254/src/fr.rs"""

    p = C.R
    generator = C.FR_GENERATOR
    s = C.FR_S
    t = C.FR_T
    root_of_unity = C.FR_ROOT_OF_UNITY


class Fq(PrimeField):
    """BN254 base field (= Grumpkin scalar field). bn254/src/fq.rs"""

    p = C.Q
    generator = C.FQ_GENERATOR
    s = C.FQ_S
    t = C.FQ_T
    root_of_unity = C.FQ_ROOT_OF_UNITY


class BlsFq(PrimeField):
    """BLS12-381 base field, the 384-bit width fixture
    (zkstd/src/arithmetic/limbs/bits_384, zkstd/tests/jubjub.rs
    bls12_381_field). q = 3 mod 4: S = 1, generator 2, root of unity -1."""

    p = C.BLS_FQ
    generator = 2
    s = 1
    t = (C.BLS_FQ - 1) // 2
    root_of_unity = C.BLS_FQ - 1
    n_bytes = 48
