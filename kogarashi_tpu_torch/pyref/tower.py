"""Pure-Python Fq2/Fq6/Fq12 extension tower oracle (the port's own copy of
`kogarashi_tpu/pyref/tower.py`).

Tower (parity: bn254/src/fqn.rs):
    Fq2  = Fq [u] / (u^2 + 1)
    Fq6  = Fq2[v] / (v^3 - xi),  xi = 9 + u
    Fq12 = Fq6[w] / (w^2 - v)

Elements are tuples of coefficients (c0, c1[, c2]) over the sub-field.
Frobenius coefficient tables are derived here at import from first principles
(xi^((q^s - 1)/k)), matching bn254/src/params.rs:59-310.
"""

from __future__ import annotations

from .. import constants as C
from .field import Fq


class Fq2:
    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fq, c1: Fq):
        self.c0, self.c1 = c0, c1

    @classmethod
    def new(cls, a: int, b: int):
        return cls(Fq(a), Fq(b))

    @classmethod
    def zero(cls):
        return cls(Fq(0), Fq(0))

    @classmethod
    def one(cls):
        return cls(Fq(1), Fq(0))

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero()

    def __eq__(self, o):
        return self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self):
        return hash((self.c0, self.c1))

    def __repr__(self):
        return f"Fq2({self.c0!r}, {self.c1!r})"

    def __add__(self, o):
        return Fq2(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return Fq2(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self):
        return Fq2(-self.c0, -self.c1)

    def __mul__(self, o):
        # (a0 + a1 u)(b0 + b1 u) with u^2 = -1
        a0, a1, b0, b1 = self.c0, self.c1, o.c0, o.c1
        return Fq2(a0 * b0 - a1 * b1, a0 * b1 + a1 * b0)

    def mul_fq(self, k: Fq):
        return Fq2(self.c0 * k, self.c1 * k)

    def square(self):
        a0, a1 = self.c0, self.c1
        return Fq2((a0 + a1) * (a0 - a1), (a0 * a1).double())

    def double(self):
        return Fq2(self.c0.double(), self.c1.double())

    def invert(self):
        n = (self.c0.square() + self.c1.square()).invert()
        if n is None:
            return None
        return Fq2(self.c0 * n, -(self.c1 * n))

    def conjugate(self):
        return Fq2(self.c0, -self.c1)

    def frobenius(self, power: int):
        """x -> x^(q^power)."""
        if power % 2 == 0:
            return self
        return self.conjugate()

    def mul_by_nonres(self):
        """Multiply by xi = 9 + u (bn254/src/fqn.rs:371)."""
        return self * XI

    def __pow__(self, e: int):
        r, b = Fq2.one(), self
        while e:
            if e & 1:
                r = r * b
            b = b.square()
            e >>= 1
        return r


XI = Fq2.new(*C.FQ2_XI)

# Frobenius coefficient tables (derived, parity: bn254/src/params.rs:59-310)
# FROBENIUS_FQ6_C1[s] = xi^((q^s - 1)/3); FROBENIUS_FQ6_C2[s] = xi^(2(q^s - 1)/3)
# FROBENIUS_FQ12_C1[s] = xi^((q^s - 1)/6)
_Q = C.Q
FROB_FQ6_C1 = [XI ** ((_Q**s - 1) // 3) for s in range(6)]
FROB_FQ6_C2 = [XI ** (2 * (_Q**s - 1) // 3) for s in range(6)]
FROB_FQ12_C1 = [XI ** ((_Q**s - 1) // 6) for s in range(12)]


class Fq6:
    __slots__ = ("c0", "c1", "c2")

    def __init__(self, c0: Fq2, c1: Fq2, c2: Fq2):
        self.c0, self.c1, self.c2 = c0, c1, c2

    @classmethod
    def zero(cls):
        return cls(Fq2.zero(), Fq2.zero(), Fq2.zero())

    @classmethod
    def one(cls):
        return cls(Fq2.one(), Fq2.zero(), Fq2.zero())

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()

    def __eq__(self, o):
        return self.c0 == o.c0 and self.c1 == o.c1 and self.c2 == o.c2

    def __repr__(self):
        return f"Fq6({self.c0!r}, {self.c1!r}, {self.c2!r})"

    def __add__(self, o):
        return Fq6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o):
        return Fq6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __neg__(self):
        return Fq6(-self.c0, -self.c1, -self.c2)

    def __mul__(self, o):
        a0, a1, a2, b0, b1, b2 = self.c0, self.c1, self.c2, o.c0, o.c1, o.c2
        t0, t1, t2 = a0 * b0, a1 * b1, a2 * b2
        c0 = t0 + ((a1 + a2) * (b1 + b2) - t1 - t2) * XI
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + t2 * XI
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return Fq6(c0, c1, c2)

    def square(self):
        return self * self

    def mul_by_fq2(self, k: Fq2):
        return Fq6(self.c0 * k, self.c1 * k, self.c2 * k)

    def mul_by_nonres(self):
        """Multiply by v: (c0,c1,c2) -> (xi*c2, c0, c1)."""
        return Fq6(self.c2 * XI, self.c0, self.c1)

    def mul_by_1(self, b1: Fq2):
        """Sparse mul by (0, b1, 0). bn254/src/fqn.rs:497"""
        return Fq6(self.c2 * b1 * XI, self.c0 * b1, self.c1 * b1)

    def mul_by_01(self, b0: Fq2, b1: Fq2):
        """Sparse mul by (b0, b1, 0). bn254/src/fqn.rs:505"""
        t0, t1 = self.c0 * b0, self.c1 * b1
        c0 = (self.c1 + self.c2) * b1 - t1
        c0 = c0 * XI + t0
        c2 = (self.c0 + self.c2) * b0 - t0 + t1
        c1 = (self.c0 + self.c1) * (b0 + b1) - t0 - t1
        return Fq6(c0, c1, c2)

    def invert(self):
        a0, a1, a2 = self.c0, self.c1, self.c2
        t0 = a0.square() - a1 * a2 * XI
        t1 = a2.square() * XI - a0 * a1
        t2 = a1.square() - a0 * a2
        d = (a0 * t0 + (a2 * t1 + a1 * t2) * XI).invert()
        if d is None:
            return None
        return Fq6(t0 * d, t1 * d, t2 * d)

    def frobenius(self, power: int):
        return Fq6(
            self.c0.frobenius(power),
            self.c1.frobenius(power) * FROB_FQ6_C1[power % 6],
            self.c2.frobenius(power) * FROB_FQ6_C2[power % 6],
        )


class Fq12:
    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fq6, c1: Fq6):
        self.c0, self.c1 = c0, c1

    @classmethod
    def zero(cls):
        return cls(Fq6.zero(), Fq6.zero())

    @classmethod
    def one(cls):
        return cls(Fq6.one(), Fq6.zero())

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero()

    def __eq__(self, o):
        return self.c0 == o.c0 and self.c1 == o.c1

    def __repr__(self):
        return f"Fq12({self.c0!r}, {self.c1!r})"

    def __add__(self, o):
        return Fq12(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return Fq12(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self):
        return Fq12(-self.c0, -self.c1)

    def double(self):
        return self + self

    def __mul__(self, o):
        a0, a1, b0, b1 = self.c0, self.c1, o.c0, o.c1
        t0, t1 = a0 * b0, a1 * b1
        return Fq12(t0 + t1.mul_by_nonres(), (a0 + a1) * (b0 + b1) - t0 - t1)

    def square(self):
        a0, a1 = self.c0, self.c1
        t = a0 * a1
        c0 = (a0 + a1) * (a0 + a1.mul_by_nonres()) - t - t.mul_by_nonres()
        return Fq12(c0, t + t)

    def invert(self):
        d = (self.c0.square() - self.c1.square().mul_by_nonres()).invert()
        if d is None:
            return None
        return Fq12(self.c0 * d, -(self.c1 * d))

    def conjugate(self):
        """x -> x^(q^6): negate c1 (unitary inverse on the cyclotomic subgroup)."""
        return Fq12(self.c0, -self.c1)

    def frobenius(self, power: int):
        c0 = self.c0.frobenius(power)
        c1 = self.c1.frobenius(power)
        coeff = FROB_FQ12_C1[power % 12]
        return Fq12(c0, Fq6(c1.c0 * coeff, c1.c1 * coeff, c1.c2 * coeff))

    def mul_by_034(self, c0: Fq2, c3: Fq2, c4: Fq2):
        """Sparse mul by (c0,0,0, c3,c4,0) — line evaluation (bn254/src/fqn.rs:570)."""
        t0 = Fq6(self.c0.c0 * c0, self.c0.c1 * c0, self.c0.c2 * c0)
        t1 = self.c1.mul_by_01(c3, c4)
        o = c0 + c3
        t2 = (self.c0 + self.c1).mul_by_01(o, c4)
        return Fq12(t1.mul_by_nonres() + t0, t2 - t0 - t1)

    def __pow__(self, e: int):
        if e < 0:
            return self.invert() ** (-e)
        r, b = Fq12.one(), self
        while e:
            if e & 1:
                r = r * b
            b = b.square()
            e >>= 1
        return r

    # -- flattening for serialization / transport --------------------------
    def to_fq_list(self) -> list[Fq]:
        out = []
        for f6 in (self.c0, self.c1):
            for f2 in (f6.c0, f6.c1, f6.c2):
                out.extend([f2.c0, f2.c1])
        return out

    @classmethod
    def from_fq_list(cls, xs):
        assert len(xs) == 12
        f2s = [Fq2(xs[2 * i], xs[2 * i + 1]) for i in range(6)]
        return cls(Fq6(*f2s[:3]), Fq6(*f2s[3:]))
