"""ff-ecosystem interop layer + 97-byte raw point serialization.

Parity: bn254/src/ff_compat.rs:30-250 (ff::Field / ff::PrimeField surface for
Fr and Fq: 32-byte little-endian standard-form reprs, TWO_INV /
ROOT_OF_UNITY_INV / DELTA constants, is_odd) and bn254/src/g1.rs:34-59 +
grumpkin/src/curve.rs:18-59 (RAW_SIZE = 97: x, y as little-endian dumps of
the *Montgomery-form* u64 limbs, then one infinity byte;
`from_slice_unchecked` performs no validation — mirrored here, plus a
validated decoder the reference lacks).

All constants are derived from the field parameters (they are mathematically
determined: TWO_INV = 2^-1, ROOT_OF_UNITY_INV = w^-1, DELTA = g^(2^s)) and
pinned by tests against independently recomputed values.

The port's own copy of `kogarashi_tpu/utils/ff_compat.py`, on the port's
pyref and errors (tests/test_torch_host.py holds the two equal).
"""

from __future__ import annotations

from .. import constants as C
from ..pyref.curve import AffinePoint

RAW_SIZE = 97
_R256 = 1 << 256


class _FFParams:
    def __init__(self, p: int, generator: int, s: int, root_of_unity: int):
        self.modulus = p
        self.num_bits = p.bit_length()
        self.capacity = self.num_bits - 1
        self.s = s
        self.two_inv = pow(2, -1, p)
        self.multiplicative_generator = generator
        self.root_of_unity = root_of_unity
        self.root_of_unity_inv = pow(root_of_unity, -1, p)
        # ff::PrimeField::DELTA = g^(2^s): generator of the 2^s-torsion-free
        # part left after quotienting the 2-adic subgroup
        self.delta = pow(generator, 1 << s, p)


FR_PARAMS = _FFParams(C.R, C.FR_GENERATOR, C.FR_S, C.FR_ROOT_OF_UNITY)
FQ_PARAMS = _FFParams(C.Q, C.FQ_GENERATOR, C.FQ_S, C.FQ_ROOT_OF_UNITY)


def to_repr(v, p: int | None = None) -> bytes:
    """Standard-form 32-byte little-endian repr (ff::PrimeField::to_repr)."""
    val = v.v if hasattr(v, "v") else int(v)
    return val.to_bytes(32, "little")


def from_repr(data: bytes, field):
    """32-byte LE -> field element; None if >= modulus (CtOption::none
    analogue — NB the reference's Fr::from_repr skips this check; we reject
    non-canonical bytes like its Fq counterpart does)."""
    assert len(data) == 32
    val = int.from_bytes(data, "little")
    if val >= field.p:
        return None
    return field(val)


def is_odd(v) -> bool:
    return bool((v.v if hasattr(v, "v") else int(v)) & 1)


# -- 97-byte raw point serialization (Montgomery-form limb dumps) -----------


def to_raw_bytes(pt: AffinePoint) -> bytes:
    """x, y as LE dumps of the Montgomery-form value (v * 2^256 mod p),
    32 zero bytes of padding, then the infinity byte at offset 96 — the
    reference's exact RAW_SIZE = 97 layout (grumpkin/src/curve.rs:45-59;
    the padding is a BLS12-381 48-byte-limb leftover it preserves)."""
    p = pt.spec.field.p

    def mont(v):
        return (v.v * _R256 % p).to_bytes(32, "little")

    return (
        mont(pt.x)
        + mont(pt.y)
        + b"\x00" * 32
        + (b"\x01" if pt.is_infinity else b"\x00")
    )


def from_slice_unchecked(data: bytes, spec) -> AffinePoint:
    """Parity with G1Affine::from_slice_unchecked (g1.rs:37-59): reads raw
    Montgomery limbs with NO validation; short input means not-infinity."""
    p = spec.field.p
    rinv = pow(_R256, -1, p)
    x = int.from_bytes(data[0:32], "little") * rinv % p
    y = int.from_bytes(data[32:64], "little") * rinv % p
    inf = len(data) >= RAW_SIZE and data[RAW_SIZE - 1] == 1
    return AffinePoint(spec, spec.field(x), spec.field(y), inf)


def from_raw_bytes(data: bytes, spec) -> AffinePoint:
    """Validated decoder: canonical Montgomery limbs + on-curve check."""
    from ..errors import MalformedProof

    if len(data) != RAW_SIZE:
        raise MalformedProof(f"raw point needs {RAW_SIZE} bytes, got {len(data)}")
    p = spec.field.p
    for off in (0, 32):
        if int.from_bytes(data[off : off + 32], "little") >= p:
            raise MalformedProof("non-canonical Montgomery limbs")
    pt = from_slice_unchecked(data, spec)
    if not pt.is_infinity:
        x, y, b = pt.x.v, pt.y.v, spec.b.v
        if (y * y - (x * x % p * x + b)) % p != 0:
            raise MalformedProof("point not on curve")
    return pt
