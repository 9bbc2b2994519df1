"""Relaxed R1CS shapes, instances and witnesses for Nova folding.

Counterpart of `kogarashi_tpu/nova/relaxed_r1cs.py` (parity:
nova/src/relaxed_r1cs.rs + relaxed_r1cs/{instance,witness}.rs). Field values
are host ints; commitments are pyref AffinePoints on the driver's commitment
curve (G1 for the Fr circuit, Grumpkin for the Fq one).

The shape's matrix products run on the device, where the JAX package runs
them on its native C++ CSR: A, B and C go to the device once per shape (and
instance length) as COO triples over the driver's scalar field (FR for the
primary circuit, FQ for the secondary), and each product is one
`ops.spmv.coo_matvec`. The NIFS cross term and the satisfiability checks
are formed there too; ints come back only where the protocol needs them.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import constants as C
from ..devices import resolve
from ..fields import mont
from ..fields.spec import FQ, FR, FieldSpec
from ..ops import spmv
from ..pyref import MimcRO
from ..r1cs import WitnessCS


@dataclass(eq=False)
class R1csShape:
    """Frozen structure (m, l, m_l_1, A, B, C) of a synthesized R1CS; its
    products run on `device`."""

    driver: object
    m: int
    instance_length: int  # l (public inputs, excluding the one-wire)
    witness_length: int  # m_l_1
    a: list  # LinComb rows
    b: list
    c: list
    device: torch.device

    @classmethod
    def from_r1cs(cls, cs, device=None) -> "R1csShape":
        """`device`: where the products run (None: the card). A WitnessCS
        has no rows to freeze, and raises."""
        if isinstance(cs, WitnessCS):
            raise TypeError("a WitnessCS keeps no rows: freeze a shape from an R1CS")
        device = resolve(device)
        return cls(
            driver=cs.driver,
            m=cs.m,
            instance_length=cs.l() - 1,
            witness_length=cs.m_l_1(),
            a=list(cs.a),
            b=list(cs.b),
            c=list(cs.c),
            device=device,
        )

    @property
    def p(self) -> int:
        return self.driver.scalar.p

    @property
    def spec(self) -> FieldSpec:
        """The device field of the constraints: FR (primary) or FQ (secondary)."""
        return FR if self.p == FR.p else FQ

    def l(self) -> int:
        return self.instance_length

    def m_l_1(self) -> int:
        return self.witness_length

    def _matrices(self, l: int) -> list:
        """[A, B, C] as COO dicts on the device for z = [u | x | w] with
        len(x) = l - 1: ("x", i) is column i, ("w", i) column i + l."""
        cache = self.__dict__.setdefault("_coo", {})
        mats = cache.get(l)
        if mats is None:
            mats = []
            for rows in (self.a, self.b, self.c):
                ri, ci, vals = [], [], []
                for i, row in enumerate(rows):
                    for (kind, k), coeff in row.terms.items():
                        ri.append(i)
                        ci.append(k if kind == "x" else k + l)
                        vals.append(coeff)
                mats.append(spmv.coo_matrix(ri, ci, vals, self.spec, self.device))
            mats = cache[l] = mats
        return mats

    def encode(self, vals):
        """Field ints -> (16, n) int64 Montgomery halves on the device."""
        words = torch.from_numpy(self.spec.encode(vals)).to(self.device)
        return mont.to_halves(words)

    def decode(self, halves) -> list:
        """(16, n) halves on the device -> field ints."""
        return self.spec.decode(mont.to_words(halves).cpu().numpy())

    def products(self, u: int, x: list, w: list):
        """(A z, B z, C z) for z = [u | x | w], as (16, m) halves on the
        device (SparseMatrix::prod, relaxed_r1cs.rs)."""
        l = len(x) + 1
        z = mont.to_words(self.encode([u] + list(x) + list(w)))
        return tuple(mont.to_halves(spmv.matvec(mat, z, self.m, self.spec))
                     for mat in self._matrices(l))

    def _lengths_ok(self, x: list, w: list) -> bool:
        return len(x) == self.l() and len(w) == self.m_l_1()

    def cross_term(self, instance1, witness1, instance2, witness2) -> list:
        """T = AZ1 o BZ2 + AZ2 o BZ1 - u1 CZ2 - u2 CZ1 with u2 = 1
        (prover.rs:53-90), on the device; returned as ints."""
        F = mont.field(self.spec)
        az1, bz1, cz1 = self.products(instance1.u, instance1.x, witness1.w)
        az2, bz2, cz2 = self.products(1, instance2.x, witness2.w)
        u1 = self.encode([instance1.u])
        m1, m2, m3 = F.mul_many([(az2, bz1), (az1, bz2), (u1.expand_as(cz2), cz2)])
        return self.decode(F.sub(F.sub(F.add(m1, m2), m3), cz1))

    def is_sat_relaxed(self, instance: "RelaxedR1csInstance", witness: "RelaxedR1csWitness") -> bool:
        """(A.z) o (B.z) == u*(C.z) + E with z = [u, x, w], on the device."""
        if not self._lengths_ok(instance.x, witness.w) or len(witness.e) != self.m:
            return False
        F = mont.field(self.spec)
        az, bz, cz = self.products(instance.u, instance.x, witness.w)
        u = self.encode([instance.u]).expand_as(cz)
        lhs, ucz = F.mul_many([(az, bz), (u, cz)])
        return bool(torch.equal(lhs, F.add(ucz, self.encode(witness.e))))

    def is_sat(self, ck, instance: "R1csInstance", witness: "R1csWitness") -> bool:
        """(A.z) o (B.z) == C.z with z = [1, x, w], and the witness commitment."""
        if not self._lengths_ok(instance.x, witness.w):
            return False
        F = mont.field(self.spec)
        az, bz, cz = self.products(1, instance.x, witness.w)
        constraints = bool(torch.equal(F.mul(az, bz), cz))
        return constraints and instance.commit_w == ck.commit(witness.w)


@dataclass
class R1csInstance:
    commit_w: object  # AffinePoint
    x: list  # ints, len l

    @classmethod
    def dummy(cls, driver, x_len: int) -> "R1csInstance":
        return cls(commit_w=driver.commit_curve.identity_affine(), x=[0] * x_len)


@dataclass
class R1csWitness:
    w: list

    def commit(self, ck):
        return ck.commit(self.w)


@dataclass
class RelaxedR1csInstance:
    driver: object
    commit_w: object
    commit_e: object
    u: int
    x: list

    @classmethod
    def dummy(cls, driver, x_len: int) -> "RelaxedR1csInstance":
        ident = driver.commit_curve.identity_affine()
        return cls(driver=driver, commit_w=ident, commit_e=ident, u=0, x=[0] * x_len)

    @classmethod
    def from_r1cs_instance(cls, driver, instance: R1csInstance) -> "RelaxedR1csInstance":
        ident = driver.commit_curve.identity_affine()
        return cls(
            driver=driver,
            commit_w=instance.commit_w,
            commit_e=ident,
            u=1,
            x=list(instance.x),
        )

    def fold(self, instance: R1csInstance, r: int, commit_t) -> "RelaxedR1csInstance":
        p = self.driver.scalar.p
        return RelaxedR1csInstance(
            driver=self.driver,
            commit_e=self.commit_e + r * commit_t,
            u=(self.u + r) % p,
            commit_w=self.commit_w + r * instance.commit_w,
            x=[(a + r * b) % p for a, b in zip(self.x, instance.x)],
        )

    def absorb_by_transcript(self, transcript: MimcRO):
        """instance.rs:103 — points, u (as base), x as 4x64-bit limbs (as base)."""
        base = self.driver.base
        transcript.append_point(self.commit_w)
        transcript.append_point(self.commit_e)
        transcript.append(base(self.u % base.p))
        for x in self.x:
            for limb_i in range(C.BN_N_LIMBS):
                limb = (x >> (C.BN_LIMB_WIDTH * limb_i)) & ((1 << C.BN_LIMB_WIDTH) - 1)
                transcript.append(base(limb))

    def hash(self, i: int, z0: list, zi: list) -> int:
        """hash(i, z0, zi, self) squeezed to HASH_BITS (instance.rs:118)."""
        base, scalar = self.driver.base, self.driver.scalar
        ro = MimcRO(base, scalar)
        ro.append(base(i))
        ro.append_vec([base(v) for v in z0])
        ro.append_vec([base(v) for v in zi])
        self.absorb_by_transcript(ro)
        return ro.squeeze(C.HASH_BITS).v


@dataclass
class RelaxedR1csWitness:
    w: list
    e: list

    @classmethod
    def dummy(cls, w_len: int, m: int) -> "RelaxedR1csWitness":
        return cls(w=[0] * w_len, e=[0] * m)

    @classmethod
    def from_r1cs_witness(cls, shape: R1csShape, witness: R1csWitness) -> "RelaxedR1csWitness":
        return cls(w=list(witness.w), e=[0] * shape.m)

    def fold(self, witness: R1csWitness, r: int, t: list, p: int) -> "RelaxedR1csWitness":
        return RelaxedR1csWitness(
            w=[(a + r * b) % p for a, b in zip(self.w, witness.w)],
            e=[(a + r * b) % p for a, b in zip(self.e, t)],
        )


def r1cs_instance_and_witness(cs, shape: R1csShape, ck):
    """(R1csInstance, R1csWitness) from a synthesized circuit
    (relaxed_r1cs.rs:24-40)."""
    assert cs.m_l_1() == shape.m_l_1()
    assert cs.m == shape.m
    w = list(cs.w)
    x = list(cs.x[1:])
    assert len(x) == shape.l()
    witness = R1csWitness(w=w)
    commit_w = witness.commit(ck)
    return R1csInstance(commit_w=commit_w, x=x), witness
