"""R1CS core: wires, linear combinations, constraint matrices.

Parity: zkstd/src/r1cs.rs (R1cs, gates, is_sat, z_vectors), r1cs/wire.rs
(Wire), matrix/row.rs (SparseRow), matrix.rs (SparseMatrix x_and_w / prod).

Values are plain ints in [0, p); rows are {wire: coeff} dicts. A wire is a
('x'|'w', index) tuple — ('x', 0) is the constant-one wire.

Two constraint systems take the same gadget calls: `R1CS` keeps every
constraint's rows (to freeze a shape, or to prove with Groth16), and
`WitnessCS` keeps only the values and the count of constraints, for a
circuit whose shape is already frozen (bellpepper's `WitnessCS`, which
microsoft/Nova's `prove_step` synthesizes into). A gadget's linear
combinations are the system's kind: `LinComb`s in an R1CS, `ConstantPart`s
in a WitnessCS.
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


class ConstantPart:
    """What a WitnessCS keeps of a linear combination: what constant folding
    reads (`LinComb.as_constant`). `c` is the constant term while the
    combination has no wire term (0: no term at all), None once it has one.

    Wire terms that cancel (`(x + 5) - x`) leave a LinComb with only its
    constant, which folds, and a ConstantPart with None, which does not:
    the WitnessCS then allocates where the R1CS folded, and its m no longer
    matches the frozen shape's (`r1cs_instance_and_witness` asserts it).
    """

    __slots__ = ("p", "c")

    def __init__(self, p: int, c: Optional[int]):
        self.p = p
        self.c = c

    def __add__(self, o: "ConstantPart") -> "ConstantPart":
        if self.c is None:
            return self
        if o.c is None:
            return o
        return ConstantPart(self.p, (self.c + o.c) % self.p)

    def __sub__(self, o: "ConstantPart") -> "ConstantPart":
        if self.c is None:
            return self
        if o.c is None:
            return o
        return ConstantPart(self.p, (self.c - o.c) % self.p)

    def __neg__(self) -> "ConstantPart":
        return self if self.c is None else ConstantPart(self.p, -self.c % self.p)

    def scale(self, k: int) -> "ConstantPart":
        if k % self.p == 0:
            return ConstantPart(self.p, 0)
        return self if self.c is None else ConstantPart(self.p, self.c * k % self.p)

    def as_constant(self) -> Optional[int]:
        return self.c or None


class ConstraintSystem:
    """Wires and their values over the scalar field of `driver`: x[0] = 1
    (constant wire); public inputs/outputs append to x, private values to
    w; m counts the constraints."""

    def __init__(self, driver):
        self.driver = driver
        self.p = driver.scalar.p
        self.m = 0
        self.x: list[int] = [1]
        self.w: list[int] = []

    def l(self) -> int:
        return len(self.x)

    def m_l_1(self) -> int:
        return len(self.w)

    def public_wire(self) -> Wire:
        return ("x", len(self.x))

    def private_wire(self) -> Wire:
        return ("w", len(self.w))

    def wire_value(self, wire: Wire) -> int:
        kind, i = wire
        return self.x[i] if kind == "x" else self.w[i]


class WitnessCS(ConstraintSystem):
    """The values of a circuit and its count of constraints, without rows:
    for a circuit whose shape an R1CS has frozen."""

    def __init__(self, driver):
        super().__init__(driver)
        self._wired = ConstantPart(self.p, None)

    def wire_lc(self, wire: Wire) -> ConstantPart:
        return self._wired

    def const_lc(self, c: int) -> ConstantPart:
        return ConstantPart(self.p, c % self.p)

    def one_lc(self) -> ConstantPart:
        return ConstantPart(self.p, 1)

    def append(self, *lcs):
        self.m += 1

    mul_gate = add_gate = sub_gate = equal_gate = append


class R1CS(ConstraintSystem):
    """Constraint system with its rows. a/b/c hold one LinComb per
    constraint: (a_i . z) * (b_i . z) = (c_i . z) with z = x || w.
    """

    def __init__(self, driver):
        super().__init__(driver)
        self.a: list[LinComb] = []
        self.b: list[LinComb] = []
        self.c: list[LinComb] = []

    def wire_lc(self, wire: Wire) -> LinComb:
        return LinComb.from_wire(self.p, wire)

    def const_lc(self, c: int) -> LinComb:
        return LinComb.from_const(self.p, c)

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
