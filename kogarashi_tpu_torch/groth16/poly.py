"""Polynomial newtypes mirroring groth16/src/poly.rs:10-238.

`Coefficients` (coefficient form) and `PointsValue` (evaluation form) over a
pyref field class. These are the host-side O(n) helpers the reference exposes
(commit, Horner evaluate, synthetic division, vanishing t, blinding); the
prover's bulk polynomial work stays on the device (ops/ntt.py) — these exist for
parity and for small/host paths.

The port's own copy of `kogarashi_tpu/groth16/poly.py`, over the port's
pyref fields (tests/test_torch_host.py holds the two equal).
"""

from __future__ import annotations

import random
from typing import Iterable, List


class Coefficients:
    """Dense coefficient form, index i = coefficient of X^i (poly.rs:10)."""

    def __init__(self, coeffs: Iterable):
        self.c: List = list(coeffs)

    def __len__(self):
        return len(self.c)

    def __eq__(self, o):
        return isinstance(o, Coefficients) and self.c == o.c

    def __repr__(self):
        return f"Coefficients({self.c!r})"

    def commit(self, domain: List):
        """Inner product with the tail of `domain` (poly.rs:82-90) — the
        KZG-style commit against a powers-of-tau domain."""
        assert len(self.c) <= len(domain)
        diff = len(domain) - len(self.c)
        acc = None
        for a, b in zip(self.c, domain[diff:]):
            t = a * b
            acc = t if acc is None else acc + t
        return acc if acc is not None else _zero_like(domain[0])

    def evaluate(self, at):
        """Horner evaluation (poly.rs:93-99)."""
        acc = _zero_like(at)
        for coeff in reversed(self.c):
            acc = acc * at + coeff
        return acc

    def divide(self, at):
        """Synthetic division: (f(X) - f(at)) / (X - at), no remainder
        (poly.rs:102-117)."""
        out = []
        w = _zero_like(at)
        for coeff in reversed(self.c):
            tmp = w + coeff
            w = tmp * at
            out.append(tmp)
        out.pop()
        out.reverse()
        return Coefficients(out)

    @staticmethod
    def t(n: int, tau):
        """Vanishing polynomial of the size-n domain at tau: tau^n - 1
        (poly.rs:120-123)."""
        acc = _one_like(tau)
        base, e = tau, n
        while e:
            if e & 1:
                acc = acc * base
            base = base * base
            e >>= 1
        return acc - _one_like(tau)

    def blind(self, hiding_degree: int, rng: random.Random, field):
        """In-place blinding (poly.rs:125-133): subtract random b_i from
        coefficient i and append b_i as a new top coefficient."""
        for i in range(hiding_degree + 1):
            b = field(rng.randrange(field.p))
            self.c[i] = self.c[i] - b
            self.c.append(b)
        return self

    def format_degree(self) -> "Coefficients":
        """Strip trailing zero coefficients (poly.rs:141-146)."""
        c = list(self.c)
        while c and c[-1].is_zero():
            c.pop()
        return Coefficients(c)

    def degree(self) -> int:
        return max(len(self.format_degree().c) - 1, 0)

    def __add__(self, o: "Coefficients"):
        a, b = self.c, o.c
        if len(a) < len(b):
            a, b = b, a
        out = list(a)
        for i, v in enumerate(b):
            out[i] = out[i] + v
        return Coefficients(out)

    def __sub__(self, o: "Coefficients"):
        out = list(self.c)
        while len(out) < len(o.c):
            out.append(_zero_like(o.c[0]))
        for i, v in enumerate(o.c):
            out[i] = out[i] - v
        return Coefficients(out)

    def __mul__(self, o):
        if isinstance(o, Coefficients):
            if not self.c or not o.c:
                return Coefficients([])
            z = _zero_like(self.c[0])
            out = [z] * (len(self.c) + len(o.c) - 1)
            for i, a in enumerate(self.c):
                for j, b in enumerate(o.c):
                    out[i + j] = out[i + j] + a * b
            return Coefficients(out)
        return Coefficients([a * o for a in self.c])


class PointsValue:
    """Evaluation form on the FFT domain (poly.rs:37)."""

    def __init__(self, values: Iterable):
        self.v: List = list(values)

    def __len__(self):
        return len(self.v)

    def __eq__(self, o):
        return isinstance(o, PointsValue) and self.v == o.v

    def __add__(self, o: "PointsValue"):
        return PointsValue([a + b for a, b in zip(self.v, o.v)])

    def __sub__(self, o: "PointsValue"):
        return PointsValue([a - b for a, b in zip(self.v, o.v)])

    def __mul__(self, o: "PointsValue"):
        return PointsValue([a * b for a, b in zip(self.v, o.v)])


def _zero_like(x):
    return type(x)(0)


def _one_like(x):
    return type(x)(1)
