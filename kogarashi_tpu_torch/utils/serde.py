"""SCALE-style encoding of Nova recursive proofs.

The port's own copy of the encoder of `kogarashi_tpu/utils/serde.py`
(`Codec` :39-92, `encode_recursive_proof` :160-188): the sha256 of a proof's
bytes is how the port's chain is held to the JAX package's. Decoding, and
the pallet that verifies decoded proofs, are not ported yet.

Wire conventions (nova/src/proof.rs:11, relaxed_r1cs.rs derive Encode):
  - field elements: 32-byte little-endian of the *Montgomery-form* value
    (Fr(pub [u64;4]) derives Encode on the raw representation);
  - affine points: x || y || bool(is_infinity) byte;
  - Vec<T>: SCALE compact length prefix then elements;
  - u64 compact: SCALE compact integer encoding.
"""

from __future__ import annotations

from ..fields.spec import MONT_R


def _to_mont_bytes(v: int, p: int) -> bytes:
    return (v * MONT_R % p).to_bytes(32, "little")


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
