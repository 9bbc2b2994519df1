"""RedDSA (rerandomizable Schnorr) over a twisted Edwards curve.

Scheme (vk = [sk]G, signatures in the prime-order subgroup):

  sign(sk, m):   r = H*(T || vk || m)   T = 80 random bytes
                 R = [r]G
                 S = r + H*(R || vk || m) * sk   (mod order)
                 sig = R.compressed || S-le32

  verify(vk, m): c = H*(R || vk || m)
                 [cofactor]([S]G - R - [c]vk) == identity

  randomize(sk, alpha): rsk = sk + alpha; rvk = vk + [alpha]G — signatures
  made with rsk verify under rvk (the rerandomization property that makes
  this "Red"DSA rather than plain Schnorr).

H* = Blake2b-512(person=b"Kogarashi_RedDSA") reduced mod order (wide
reduction). Parity surface: zkstd/src/traits/sign.rs (SigUtils<32>/RedDSA);
point compression per zkstd/tests/jubjub.rs SigUtils<32> for JubjubAffine.

The port's own copy of `kogarashi_tpu/signature/reddsa.py`: the host code
(hashing, keys, signing, host verify) is the same; `batch_verify` runs its
scalar multiplies and the combine on the card (csrc/edwards.cu E1-E3).
"""

from __future__ import annotations

import hashlib
import logging
import secrets
from dataclasses import dataclass

import torch

from ..curves.edwards import JUBJUB, eadd, edouble, scalar_mul
from ..devices import resolve
from ..fields.spec import ints_to_limbs16
from ..pyref.edwards import (
    EdwardsAffine,
    EdwardsSpec,
    JUBJUB_SPEC,
)
from ..stages import Stages

LOG = logging.getLogger(__name__)

_PERSON = b"Kogarashi_RedDSA"


def hash_to_scalar(spec: EdwardsSpec, *chunks: bytes) -> int:
    """H*: Blake2b-512 of the concatenation, wide-reduced mod the order."""
    h = hashlib.blake2b(digest_size=64, person=_PERSON)
    for c in chunks:
        h.update(c)
    return int.from_bytes(h.digest(), "little") % spec.order


@dataclass(frozen=True)
class Signature:
    """64 bytes: compressed R || S (little-endian 32 bytes)."""

    r_bytes: bytes
    s: int

    LENGTH = 64

    def to_bytes(self) -> bytes:
        return self.r_bytes + self.s.to_bytes(32, "little")

    @classmethod
    def from_bytes(cls, b: bytes):
        if len(b) != cls.LENGTH:
            return None
        return cls(bytes(b[:32]), int.from_bytes(b[32:], "little"))


@dataclass(frozen=True)
class VerificationKey:
    spec: EdwardsSpec
    point: EdwardsAffine  # [sk]G

    LENGTH = 32

    def to_bytes(self) -> bytes:
        return self.point.to_bytes()

    @classmethod
    def from_bytes(cls, spec: EdwardsSpec, b: bytes):
        p = EdwardsAffine.from_bytes(spec, b)
        return None if p is None else cls(spec, p)

    def randomize(self, alpha: int) -> "VerificationKey":
        g = self.spec.generator.to_extended()
        return VerificationKey(
            self.spec, (self.point.to_extended() + alpha * g).to_affine()
        )

    def verify(self, msg: bytes, sig: Signature) -> bool:
        spec = self.spec
        r_pt = EdwardsAffine.from_bytes(spec, sig.r_bytes)
        if r_pt is None or sig.s >= spec.order:
            return False
        c = hash_to_scalar(spec, sig.r_bytes, self.to_bytes(), msg)
        g = spec.generator.to_extended()
        # [cofactor]([S]G - R - [c]vk) == identity
        lhs = sig.s * g - r_pt.to_extended() - c * self.point.to_extended()
        return (spec.cofactor * lhs).is_identity()


@dataclass(frozen=True)
class SecretKey:
    spec: EdwardsSpec
    sk: int

    LENGTH = 32

    @classmethod
    def random(cls, spec: EdwardsSpec = JUBJUB_SPEC, rng=None) -> "SecretKey":
        if rng is not None:
            k = rng.randrange(1, spec.order)
        else:
            k = secrets.randbelow(spec.order - 1) + 1
        return cls(spec, k)

    def to_bytes(self) -> bytes:
        return self.sk.to_bytes(32, "little")

    @classmethod
    def from_bytes(cls, spec: EdwardsSpec, b: bytes):
        v = int.from_bytes(b, "little")
        return None if v >= spec.order else cls(spec, v)

    def verification_key(self) -> VerificationKey:
        g = self.spec.generator.to_extended()
        return VerificationKey(self.spec, (self.sk * g).to_affine())

    def randomize(self, alpha: int) -> "SecretKey":
        return SecretKey(self.spec, (self.sk + alpha) % self.spec.order)

    def sign(self, msg: bytes, rng=None) -> Signature:
        spec = self.spec
        t = (
            bytes(rng.randrange(256) for _ in range(80))
            if rng
            else secrets.token_bytes(80)
        )
        vk_b = self.verification_key().to_bytes()
        r = hash_to_scalar(spec, t, vk_b, msg)
        g = spec.generator.to_extended()
        r_bytes = (r * g).to_affine().to_bytes()
        c = hash_to_scalar(spec, r_bytes, vk_b, msg)
        s = (r + c * self.sk) % spec.order
        return Signature(r_bytes, s)


class RedDSA:
    """Driver-style bundle (zkstd/src/traits/sign.rs RedDSA) for a curve."""

    def __init__(self, spec: EdwardsSpec = JUBJUB_SPEC):
        self.spec = spec

    def keygen(self, rng=None) -> tuple[SecretKey, VerificationKey]:
        sk = SecretKey.random(self.spec, rng)
        return sk, sk.verification_key()


def batch_verify(vks, msgs, sigs, spec: EdwardsSpec = JUBJUB_SPEC, device=None) -> list:
    """Batched verification of n signatures on `device` (None: the card).

    The host hashes and decompresses; the 2n variable-base scalar muls
    ([S_i]G and [c_i]vk_i) run as ONE E1 launch over 2n lanes; then
    d_i = [S_i]G - (R_i + [c_i]vk_i) (two E2 launches, the negation folded
    into the second), the cofactor multiply (E3, three doublings) and the
    identity test on the device. Invalid lanes (R does not decompress, or
    S >= order) carry R = identity and zero scalars, as in the JAX package,
    and are rejected. Returns a list of bools. Stage times are logged at
    INFO (`stages.Stages`).
    """
    device = resolve(device)
    if spec is not JUBJUB_SPEC:
        raise ValueError("the batched path is instantiated for Jubjub")
    n = len(sigs)
    if not len(vks) == len(msgs) == n:
        raise ValueError(f"{len(vks)} keys, {len(msgs)} messages and {n} signatures")
    st = Stages(LOG, "batch_verify", device)

    r_pts, cs, ss, ok = [], [], [], []
    for vk, msg, sig in zip(vks, msgs, sigs):
        r_pt = EdwardsAffine.from_bytes(spec, sig.r_bytes)
        valid = r_pt is not None and sig.s < spec.order
        ok.append(valid)
        r_pts.append(r_pt if valid else spec.identity_affine())
        cs.append(hash_to_scalar(spec, sig.r_bytes, vk.to_bytes(), msg) if valid else 0)
        ss.append(sig.s if valid else 0)
    st.mark("hash and decompress")

    # lanes 0..n-1: [S_i]G; lanes n..2n-1: [c_i]vk_i
    g = JUBJUB.encode_points([spec.generator], device)
    vk_pts = JUBJUB.encode_points([vk.point for vk in vks], device)
    bases = tuple(torch.cat([gc.expand(8, n), vc], dim=1) for gc, vc in zip(g, vk_pts))
    scalars = torch.from_numpy(ints_to_limbs16(ss + cs)).to(device)
    rr = JUBJUB.encode_points(r_pts, device)
    st.mark("encode")
    muls = scalar_mul(JUBJUB, bases, scalars)
    st.mark("scalar mul")
    sg = tuple(c[:, :n].contiguous() for c in muls)
    cvk = tuple(c[:, n:].contiguous() for c in muls)
    # d_i = [S_i]G - (R_i + [c_i]vk_i), times the cofactor (3 doublings)
    diff = eadd(JUBJUB, sg, eadd(JUBJUB, rr, cvk), neg=True)
    diff = edouble(JUBJUB, diff, spec.cofactor.bit_length() - 1)
    # The JAX package tests x == 0 and y == 1 after to_affine, whose
    # inversion maps Z = 0 to 0: on the same words that is X == 0, Y == Z
    # and Z != 0, with no inversion.
    x, y, _, z = diff
    is_id = (x == 0).all(dim=0) & (y == z).all(dim=0) & (z != 0).any(dim=0)
    st.mark("combine")
    out = [bool(o and i) for o, i in zip(ok, is_id.tolist())]
    st.mark("decode")
    return out
