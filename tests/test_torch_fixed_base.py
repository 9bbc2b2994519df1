"""The port's windowed fixed-base scalar multiplication (`ops.fixed_base`:
`FixedBaseTable` and the cached `fixed_base_mul` that Groth16's setup and
Nova's Pedersen keys call), on the CPU (K3's plain version), for G1, G2 and
Grumpkin, against the JAX package's pyref: (k mod order) times its
generator, compared by integer coordinates, since the two packages' pyref
classes never compare equal. The scalars are those of
tests/test_fixed_base.py: 0, 1, 2, order - 1, 2^128 and randoms. The file
takes about 20 s on one CPU worker, half of it building the c = 13 table."""

import pytest
import torch

from kogarashi_tpu import constants as JC
from kogarashi_tpu import pyref as jpyref
from kogarashi_tpu_torch.curves import CURVES, decode_points
from kogarashi_tpu_torch.fields.spec import ints_to_limbs16
from kogarashi_tpu_torch.ops.fixed_base import FixedBaseTable, _table, fixed_base_mul

torch.set_num_threads(2)  # the suite runs several workers side by side

# The JAX package's generator and group order of each curve.
ORACLE = {"g1": (jpyref.G1_SPEC, JC.R), "g2": (jpyref.G2_SPEC, JC.R),
          "grumpkin": (jpyref.GRUMPKIN_SPEC, JC.Q)}


def _coords(p):
    """An affine point of either package -> its coordinates as ints."""
    if p.is_infinity:
        return ("inf",)
    ints = (lambda v: (v.c0.v, v.c1.v)) if hasattr(p.x, "c1") else (lambda v: (v.v,))
    return ints(p.x), ints(p.y)


def _scalars(rng, order):
    return [0, 1, 2, order - 1, 1 << 128] + [rng.randrange(order) for _ in range(11)]


def _assert_oracle(name, ks, out):
    spec, order = ORACLE[name]
    got = decode_points(CURVES[name], out)
    assert len(got) == len(ks)
    for k, pt in zip(ks, got):
        assert _coords(pt) == _coords((k % order) * spec.generator), k


@pytest.mark.parametrize("name, c", [
    ("g1", 8),
    ("g1", 13),  # c=13 straddles 16-bit limb edges
    ("g2", 8),
    ("grumpkin", 8),
])
def test_fixed_base_table_matches_pyref(rng, name, c):
    ks = _scalars(rng, ORACLE[name][1])
    t = FixedBaseTable(CURVES[name], c=c, device="cpu")
    _assert_oracle(name, ks, t.mul(torch.from_numpy(ints_to_limbs16(ks))))


def test_fixed_base_mul_g2_matches_pyref_through_its_cache(rng):
    curve = CURVES["g2"]
    ks = _scalars(rng, JC.R)
    s = torch.from_numpy(ints_to_limbs16(ks))
    first = fixed_base_mul(curve, s[:, :8].contiguous())
    hits = _table.cache_info().hits
    second = fixed_base_mul(curve, s[:, 8:].contiguous())
    assert _table.cache_info().hits == hits + 1
    _assert_oracle("g2", ks, tuple(torch.cat([a, b], dim=-1) for a, b in zip(first, second)))
