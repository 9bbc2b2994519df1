"""Gt — the pairing target group, written additively.

Parity: bn254/src/gt.rs — Gt wraps the r-torsion unit subgroup of Fq12 with
additive notation: add = Fq12 mul, neg = conjugation (unitary inverse),
double = Fq12 square, scalar mul = exponentiation. The additive generator is
e(G1::generator, G2::generator).

The port's own copy of `kogarashi_tpu/pyref/gt.py`.
"""

from __future__ import annotations

from functools import lru_cache

from .tower import Fq12
from .field import Fr


class Gt:
    __slots__ = ("f",)

    def __init__(self, f: Fq12):
        self.f = f

    @classmethod
    def identity(cls) -> "Gt":
        return cls(Fq12.one())

    @classmethod
    def generator(cls) -> "Gt":
        """e(G1 generator, G2 generator) (bn254/src/gt.rs ADDITIVE_GENERATOR,
        precomputed in fqn.rs:150)."""
        return cls(_gt_generator())

    def is_identity(self) -> bool:
        return self.f == Fq12.one()

    def __eq__(self, o) -> bool:
        return self.f == o.f

    def __add__(self, o: "Gt") -> "Gt":
        return Gt(self.f * o.f)

    def __neg__(self) -> "Gt":
        return Gt(self.f.conjugate())

    def __sub__(self, o: "Gt") -> "Gt":
        return self + (-o)

    def double(self) -> "Gt":
        return Gt(self.f.square())

    def __mul__(self, k) -> "Gt":
        """[k]g = g^k; k is an int or Fr (scalars live in Fr)."""
        k = k.v if isinstance(k, Fr) else int(k)
        k %= Fr.p
        acc = Gt.identity()
        base = self
        while k:
            if k & 1:
                acc = acc + base
            base = base.double()
            k >>= 1
        return acc

    __rmul__ = __mul__

    def __repr__(self):
        return f"Gt({self.f!r})"


@lru_cache(maxsize=1)
def _gt_generator() -> Fq12:
    from .curve import G1_SPEC, G2_SPEC
    from .pairing_fast import pairing_fast

    return pairing_fast(G1_SPEC.generator, G2_SPEC.generator)
