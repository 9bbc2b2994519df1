"""SCALE-style serialization of Nova recursive proofs and Groth16 proofs.

The port's own copy of `kogarashi_tpu/utils/serde.py` (`Codec` :39, `Decoder`
:94, `encode_recursive_proof` :160, `decode_recursive_proof` :190,
`encode_groth16_proof` :244, `decode_groth16_proof` :261). The sha256 of a
proof's bytes is how the port's chain is held to the JAX package's; decoded
recursive proofs are the port's `RecursiveProof`, with the port's instances
and drivers, so `pallet.NovaPallet` verifies them on the card. One
deliberate difference: a truncated input raises `DecodeError` here, where
the JAX package's decoder fails an assertion.

Wire conventions (nova/src/proof.rs:11, relaxed_r1cs.rs derive Encode):
  - field elements: 32-byte little-endian of the *Montgomery-form* value
    (Fr(pub [u64;4]) derives Encode on the raw representation);
  - affine points: x || y || bool(is_infinity) byte;
  - Vec<T>: SCALE compact length prefix then elements;
  - u64 compact: SCALE compact integer encoding.
"""

from __future__ import annotations

from .. import constants as C
from ..errors import DecodeError, MalformedProof
from ..fields.spec import MONT_R
from ..groth16.keys import Proof
from ..nova.proof import RecursiveProof
from ..nova.relaxed_r1cs import R1csInstance, R1csWitness, RelaxedR1csInstance, RelaxedR1csWitness
from ..pyref import G1_SPEC, G2_SPEC, AffinePoint, Fq, Fq2
from ..pyref.subgroup import validate_point
from ..r1cs import BN254_DRIVER, GRUMPKIN_DRIVER


def _to_mont_bytes(v: int, p: int) -> bytes:
    return (v * MONT_R % p).to_bytes(32, "little")


_RINV: dict = {}  # p -> R^-1 mod p, computed once per field


def _from_mont_bytes(b: bytes, p: int) -> int:
    """Strict decode: the Montgomery representation must be canonical (< p).

    The reference decodes `Fr(pub [u64;4])` raw and trusts the producer;
    an on-chain verifier cannot, so non-canonical field bytes are rejected."""
    v = int.from_bytes(b, "little")
    if v >= p:
        raise DecodeError("non-canonical field element (>= p)")
    rinv = _RINV.get(p)
    if rinv is None:
        rinv = _RINV[p] = pow(MONT_R, -1, p)
    return v * rinv % p


class Codec:
    """Append-only SCALE-style encoder."""

    def __init__(self):
        self.buf = bytearray()

    def bytes(self) -> bytes:
        return bytes(self.buf)

    # -- primitives --------------------------------------------------------
    def compact(self, n: int) -> "Codec":
        """SCALE compact unsigned integer."""
        if n < 1 << 6:
            self.buf += (n << 2).to_bytes(1, "little")
        elif n < 1 << 14:
            self.buf += ((n << 2) | 0b01).to_bytes(2, "little")
        elif n < 1 << 30:
            self.buf += ((n << 2) | 0b10).to_bytes(4, "little")
        else:
            nbytes = (n.bit_length() + 7) // 8
            self.buf += (((nbytes - 4) << 2) | 0b11).to_bytes(1, "little")
            self.buf += n.to_bytes(nbytes, "little")
        return self

    def u8(self, v: int) -> "Codec":
        self.buf += v.to_bytes(1, "little")
        return self

    def u64(self, v: int) -> "Codec":
        self.buf += v.to_bytes(8, "little")
        return self

    def boolean(self, v: bool) -> "Codec":
        return self.u8(1 if v else 0)

    # -- crypto types ------------------------------------------------------
    def field(self, v: int, p: int) -> "Codec":
        self.buf += _to_mont_bytes(v, p)
        return self

    def fields(self, vals, p: int) -> "Codec":
        self.compact(len(vals))
        for v in vals:
            self.field(v, p)
        return self

    def point(self, pt) -> "Codec":
        """pyref AffinePoint over a prime-field curve."""
        p = pt.spec.field.p
        self.field(pt.x.v, p)
        self.field(pt.y.v, p)
        self.boolean(pt.is_infinity)
        return self


class Decoder:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def _take(self, n: int) -> bytes:
        b = self.data[self.pos : self.pos + n]
        if len(b) != n:
            raise DecodeError("decode underrun")
        self.pos += n
        return b

    def compact(self) -> int:
        if self.pos >= len(self.data):
            raise DecodeError("decode underrun")
        b0 = self.data[self.pos]
        mode = b0 & 0b11
        if mode == 0b00:
            return int.from_bytes(self._take(1), "little") >> 2
        if mode == 0b01:
            return int.from_bytes(self._take(2), "little") >> 2
        if mode == 0b10:
            return int.from_bytes(self._take(4), "little") >> 2
        nbytes = (b0 >> 2) + 4
        self._take(1)
        return int.from_bytes(self._take(nbytes), "little")

    def u8(self) -> int:
        return int.from_bytes(self._take(1), "little")

    def u64(self) -> int:
        return int.from_bytes(self._take(8), "little")

    def boolean(self) -> bool:
        return self.u8() != 0

    def field(self, p: int) -> int:
        return _from_mont_bytes(self._take(32), p)

    def fields(self, p: int) -> list[int]:
        n = self.compact()
        return [self.field(p) for _ in range(n)]

    def point(self, spec, validate: bool = True):
        """Decode an affine point; by default reject off-curve and (for G2)
        out-of-subgroup points: attacker bytes must not produce a usable
        point (reference gap: g1.rs:34-59 from_slice_unchecked validates
        nothing; the torsion checks it does ship are broken BLS12-381
        imports, see pyref/subgroup.py)."""
        p = spec.field.p
        x = spec.field(self.field(p))
        y = spec.field(self.field(p))
        inf = self.boolean()
        pt = AffinePoint(spec, x, y, inf)
        if validate and not validate_point(pt):
            raise MalformedProof(f"invalid {spec.name} point")
        return pt


def encode_recursive_proof(proof) -> bytes:
    """RecursiveProof -> bytes (nova/src/proof.rs Encode shape)."""
    e1 = proof.u_range_primary.driver
    e2 = proof.u_range_secondary.driver
    c = Codec()
    c.compact(proof.i)
    c.fields(proof.z0_primary, e1.scalar.p)
    c.fields(proof.z0_secondary, e2.scalar.p)
    c.fields(proof.zi_primary, e1.scalar.p)
    c.fields(proof.zi_secondary, e2.scalar.p)
    # (u_single_secondary, w_single_secondary)
    c.point(proof.u_single_secondary.commit_w)
    c.fields(proof.u_single_secondary.x, e2.scalar.p)
    c.fields(proof.w_single_secondary.w, e2.scalar.p)
    # (u_range_primary, w_range_primary)
    _enc_relaxed(c, proof.u_range_primary, proof.w_range_primary, e1)
    # (u_range_secondary, w_range_secondary)
    _enc_relaxed(c, proof.u_range_secondary, proof.w_range_secondary, e2)
    return c.bytes()


def _enc_relaxed(c: Codec, inst, wit, driver):
    c.point(inst.commit_w)
    c.point(inst.commit_e)
    c.field(inst.u, driver.scalar.p)
    c.fields(inst.x, driver.scalar.p)
    c.fields(wit.w, driver.scalar.p)
    c.fields(wit.e, driver.scalar.p)


def decode_recursive_proof(data: bytes) -> RecursiveProof:
    """Bytes -> the port's RecursiveProof (BN254 primary, Grumpkin secondary)."""
    e1, e2 = BN254_DRIVER, GRUMPKIN_DRIVER
    d = Decoder(data)
    i = d.compact()
    z0_p = d.fields(e1.scalar.p)
    z0_s = d.fields(e2.scalar.p)
    zi_p = d.fields(e1.scalar.p)
    zi_s = d.fields(e2.scalar.p)
    cw = d.point(e2.commit_curve)
    x = d.fields(e2.scalar.p)
    w = d.fields(e2.scalar.p)
    u_range_primary, w_range_primary = _dec_relaxed(d, e1)
    u_range_secondary, w_range_secondary = _dec_relaxed(d, e2)
    return RecursiveProof(
        i=i,
        z0_primary=z0_p,
        z0_secondary=z0_s,
        zi_primary=zi_p,
        zi_secondary=zi_s,
        u_single_secondary=R1csInstance(commit_w=cw, x=x),
        w_single_secondary=R1csWitness(w=w),
        u_range_primary=u_range_primary,
        w_range_primary=w_range_primary,
        u_range_secondary=u_range_secondary,
        w_range_secondary=w_range_secondary,
    )


def _dec_relaxed(d: Decoder, driver):
    cw = d.point(driver.commit_curve)
    ce = d.point(driver.commit_curve)
    u = d.field(driver.scalar.p)
    x = d.fields(driver.scalar.p)
    w = d.fields(driver.scalar.p)
    e = d.fields(driver.scalar.p)
    return (
        RelaxedR1csInstance(driver=driver, commit_w=cw, commit_e=ce, u=u, x=x),
        RelaxedR1csWitness(w=w, e=e),
    )


def encode_groth16_proof(proof) -> bytes:
    """Groth16 Proof {a: G1, b: G2, c: G1} -> bytes. G2 coords as c0 || c1."""
    c = Codec()
    c.point(proof.a)
    for coord in (proof.b.x, proof.b.y):
        c.field(coord.c0.v, C.Q)
        c.field(coord.c1.v, C.Q)
    c.boolean(proof.b.is_infinity)
    c.point(proof.c)
    return c.bytes()


def decode_groth16_proof(data: bytes) -> Proof:
    """Bytes -> the port's Proof; A and C on G1, B on G2 and in its r-order
    subgroup (psi check), else MalformedProof."""
    d = Decoder(data)
    a = d.point(G1_SPEC)
    coords = [Fq2(Fq(d.field(C.Q)), Fq(d.field(C.Q))) for _ in range(2)]
    b = AffinePoint(G2_SPEC, coords[0], coords[1], d.boolean())
    if not validate_point(b):
        raise MalformedProof("invalid G2 point in proof")
    return Proof(a=a, b=b, c=d.point(G1_SPEC))
