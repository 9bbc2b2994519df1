"""Vectorized R1CS construction for large circuits.

The dict-based `R1CS` builder (system.py) mirrors the reference's per-gate
`SparseRow` appends (zkstd/src/r1cs.rs:102-134) — fine for protocol circuits,
hostile at 2^20 gates. `VecR1CS` holds the three constraint matrices directly
as numpy COO arrays and the witness as a list, exposing the same interface
surface `groth16.setup`/`Prover` consume (m, l(), m_l_1(), matrices_coo(),
z_ints(), x, w, is_sat()). Coefficients are kept as a numpy array plus an
optional small value table so host->device encoding of 2^20-entry matrices
is a table lookup, not 3 million Python bigint reductions.
"""

from __future__ import annotations

import numpy as np


class VecR1CS:
    """COO-backed R1CS: columns index z = x || w (x first, constant wire 0)."""

    def __init__(self, p: int, x: list, w: list, rows, cols, vals, m: int):
        """rows/cols/vals: 3-tuples (A, B, C) of np.int32 / value arrays.
        vals entries are ints mod p (numpy object or int64 arrays)."""
        self.p = p
        self.x = x
        self.w = w
        self._rows = rows
        self._cols = cols
        self._vals = vals
        self.m = m

    def l(self) -> int:
        return len(self.x)

    def m_l_1(self) -> int:
        return len(self.w)

    def matrices_coo(self):
        return tuple(
            (np.asarray(r, np.int32), np.asarray(c, np.int32), v)
            for r, c, v in zip(self._rows, self._cols, self._vals)
        )

    def z_ints(self):
        return self.x + self.w

    def is_sat(self) -> bool:
        z = self.z_ints()
        p = self.p

        def ev(r, c, v):
            out = [0] * self.m
            for i in range(len(r)):
                out[r[i]] += int(v[i]) * z[c[i]]
            return [o % p for o in out]

        az = ev(*[np.asarray(a) for a in (self._rows[0], self._cols[0])], self._vals[0])
        bz = ev(*[np.asarray(a) for a in (self._rows[1], self._cols[1])], self._vals[1])
        cz = ev(*[np.asarray(a) for a in (self._rows[2], self._cols[2])], self._vals[2])
        return all(a * b % p == c for a, b, c in zip(az, bz, cz))


class SquareChainCircuit:
    """Benchmark circuit: repeated squarings w_{i+1} = w_i^2 with the seed
    and final value public — m constraints, <=3m single-entry COO terms, O(m)
    host work. Drop-in for `groth16.setup(circuit)` at 2^20 gates.

    The chain is m-2 squarings plus two 1*1=1 padding constraints on the
    constant wire, so that BOTH the constraint count and the wire count
    (l + m_l_1 = 3 + (m-3)) equal m exactly. With m a power of two, every
    prover MSM (h: n-1, l: m-3, a/b: m wires) pads to the same 2^k shape —
    one compiled MSM executable serves the whole proof."""

    def __init__(self, m: int, x0: int = 3, p: int | None = None):
        from .. import constants as C

        assert m >= 3
        self.m = m
        self.p = p or C.R
        self.x0 = x0 % self.p

    def build(self) -> VecR1CS:
        p, m = self.p, self.m
        mc = m - 2  # squaring-chain length
        chain = [self.x0]
        v = self.x0
        for _ in range(mc):
            v = v * v % p
            chain.append(v)
        # wires: x = [1, x0, out]; w = chain[1:-1] (intermediate squares)
        x = [1, chain[0], chain[-1]]
        w = chain[1:-1]
        l = 3

        idx = np.arange(mc, dtype=np.int32)
        cols_in = np.where(idx == 0, 1, l + idx - 1).astype(np.int32)
        cols_out = np.where(idx == mc - 1, 2, l + idx).astype(np.int32)
        # two padding rows 1*1 = 1 on the constant wire (indices mc, mc+1)
        rows_all = np.concatenate([idx, np.array([mc, mc + 1], np.int32)])
        pad_cols = np.zeros(2, np.int32)
        cols_a = np.concatenate([cols_in, pad_cols])
        cols_b = np.concatenate([cols_in, pad_cols])
        cols_c = np.concatenate([cols_out, pad_cols])
        ones = np.ones(mc + 2, dtype=np.int64)
        rows = (rows_all, rows_all, rows_all)
        cols = (cols_a, cols_b, cols_c)
        vals = (ones, ones, ones)
        return VecR1CS(p, x, w, rows, cols, vals, m)
