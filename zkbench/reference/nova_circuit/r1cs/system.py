"""R1CS core: wires, linear combinations, constraint matrices.

Parity: zkstd/src/r1cs.rs (R1cs, gates, is_sat, z_vectors), r1cs/wire.rs
(Wire), matrix/row.rs (SparseRow), matrix.rs (SparseMatrix x_and_w / prod).

Values are plain ints in [0, p); rows are {wire: coeff} dicts. A wire is a
('x'|'w', index) tuple — ('x', 0) is the constant-one wire.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

Wire = tuple  # ('x'|'w', int)
ONE: Wire = ("x", 0)


class LinComb:
    """Sparse linear combination of wires (SparseRow analogue)."""

    __slots__ = ("p", "terms")

    def __init__(self, p: int, terms: Optional[dict] = None):
        self.p = p
        self.terms = {}
        if terms:
            for w, c in terms.items():
                c %= p
                if c:
                    self.terms[w] = c

    @classmethod
    def from_wire(cls, p: int, wire: Wire, coeff: int = 1):
        return cls(p, {wire: coeff})

    @classmethod
    def from_const(cls, p: int, c: int):
        return cls(p, {ONE: c})

    def __add__(self, o: "LinComb") -> "LinComb":
        t = dict(self.terms)
        for w, c in o.terms.items():
            t[w] = (t.get(w, 0) + c) % self.p
        return LinComb(self.p, t)

    def __sub__(self, o: "LinComb") -> "LinComb":
        t = dict(self.terms)
        for w, c in o.terms.items():
            t[w] = (t.get(w, 0) - c) % self.p
        return LinComb(self.p, t)

    def __neg__(self) -> "LinComb":
        return LinComb(self.p, {w: -c for w, c in self.terms.items()})

    def scale(self, k: int) -> "LinComb":
        return LinComb(self.p, {w: c * k for w, c in self.terms.items()})

    def as_constant(self) -> Optional[int]:
        """Some(c) iff exactly one term on the constant wire (row.rs:37-43)."""
        if len(self.terms) == 1 and ONE in self.terms:
            return self.terms[ONE]
        return None

    def is_zero(self) -> bool:
        return not self.terms

    def evaluate(self, x: list, w: list) -> int:
        s = 0
        for (kind, i), c in self.terms.items():
            v = x[i] if kind == "x" else w[i]
            s += c * v
        return s % self.p


class R1CS:
    """Constraint system over the scalar field of `driver`.

    x[0] = 1 (constant wire); public inputs/outputs append to x, private
    values to w. a/b/c hold one LinComb per constraint:
    (a_i . z) * (b_i . z) = (c_i . z) with z = x || w.
    """

    def __init__(self, driver):
        self.driver = driver
        self.p = driver.scalar.p
        self.m = 0
        self.a: list[LinComb] = []
        self.b: list[LinComb] = []
        self.c: list[LinComb] = []
        self.x: list[int] = [1]
        self.w: list[int] = []

    # -- structure ---------------------------------------------------------
    def l(self) -> int:
        return len(self.x)

    def m_l_1(self) -> int:
        return len(self.w)

    def public_wire(self) -> Wire:
        return ("x", len(self.x))

    def private_wire(self) -> Wire:
        return ("w", len(self.w))

    def append(self, a: LinComb, b: LinComb, c: LinComb):
        self.a.append(a)
        self.b.append(b)
        self.c.append(c)
        self.m += 1

    def one_lc(self) -> LinComb:
        return LinComb.from_const(self.p, 1)

    def mul_gate(self, x: LinComb, y: LinComb, z: LinComb):
        self.append(x, y, z)

    def add_gate(self, x: LinComb, y: LinComb, z: LinComb):
        self.append(x + y, self.one_lc(), z)

    def sub_gate(self, x: LinComb, y: LinComb, z: LinComb):
        self.append(x - y, self.one_lc(), z)

    def equal_gate(self, x: LinComb, y: LinComb):
        self.mul_gate(x, self.one_lc(), y)

    def wire_value(self, wire: Wire) -> int:
        kind, i = wire
        return self.x[i] if kind == "x" else self.w[i]

    # -- evaluation --------------------------------------------------------
    def evaluate(self):
        """(Az, Bz, Cz) as int lists (r1cs.rs:137)."""
        az = [r.evaluate(self.x, self.w) for r in self.a]
        bz = [r.evaluate(self.x, self.w) for r in self.b]
        cz = [r.evaluate(self.x, self.w) for r in self.c]
        return az, bz, cz

    def is_sat(self) -> bool:
        az, bz, cz = self.evaluate()
        return all(a * b % self.p == c for a, b, c in zip(az, bz, cz))

    def z_vectors(self, l: int, m_l_1: int):
        """Per-wire QAP columns: ((a_x, b_x, c_x), (a_w, b_w, c_w)) where each
        entry is a list (per wire) of (coeff, constraint_index) pairs
        (matrix.rs:15 x_and_w)."""

        def x_and_w(rows):
            xs = [[] for _ in range(l)]
            ws = [[] for _ in range(m_l_1)]
            for i, row in enumerate(rows):
                for (kind, k), coeff in row.terms.items():
                    (xs if kind == "x" else ws)[k].append((coeff, i))
            return xs, ws

        ax, aw = x_and_w(self.a)
        bx, bw = x_and_w(self.b)
        cx, cw = x_and_w(self.c)
        return (ax, bx, cx), (aw, bw, cw)

    # -- device export -----------------------------------------------------
    def matrices_coo(self):
        """(row_idx, col_idx, coeff_ints) per matrix; columns index z = x||w."""
        l = self.l()

        def coo(rows):
            ri, ci, vals = [], [], []
            for i, row in enumerate(rows):
                for (kind, k), coeff in row.terms.items():
                    ri.append(i)
                    ci.append(k if kind == "x" else k + l)
                    vals.append(coeff)
            return np.asarray(ri, np.int32), np.asarray(ci, np.int32), vals

        return coo(self.a), coo(self.b), coo(self.c)

    def z_ints(self):
        return self.x + self.w
