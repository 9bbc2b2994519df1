"""The CUDA kernels against their plain versions on the card. Marked `cuda`:
without a CUDA device (the CPU test run) every test here skips. On a GPU
machine: python -m pytest tests/test_torch_cuda.py -m cuda -q"""

import random

import numpy as np
import pytest
import torch

from kogarashi_tpu import constants as C
from kogarashi_tpu_torch.curves import G1, G2, decode_points, prepare_points, to_affine
from kogarashi_tpu_torch.fields import mont
from kogarashi_tpu_torch.fields.spec import FQ, FR, ints_to_limbs16
from kogarashi_tpu_torch.ops import ec
from kogarashi_tpu_torch.ops.fixed_base import fixed_base_mul
from kogarashi_tpu_torch.ops.msm import msm

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("spec,name", [(FQ, "fq"), (FR, "fr")], ids=["fq", "fr"])
def test_field_kernel_matches_plain(dev, spec, name):
    rng = np.random.default_rng(1)
    vals = [int(v) % spec.p for v in rng.integers(0, 1 << 62, 4096)]
    a = torch.from_numpy(spec.encode([0, 1, spec.p - 1] + vals)).to(dev)
    b = a.flip(1).contiguous()
    for op in ("mul", "sqr", "add", "sub", "neg"):
        args = (a, b) if op in ("mul", "add", "sub") else (a,)
        assert torch.equal(ec.field_op_cuda(name, op, a, b), getattr(mont, op)(*args, spec=spec)), op


@pytest.mark.parametrize("curve", [G1, G2], ids=["g1", "g2"])
def test_point_kernels_match_plain(dev, curve):
    sc = np.random.default_rng(2).integers(0, 1 << 16, size=(16, 2048), dtype=np.uint32)
    sc[15] &= 0x3FFF
    p = fixed_base_mul(curve, torch.from_numpy(sc.astype(np.int32)).to(dev))
    q = tuple(t.roll(1, dims=1).contiguous() for t in p)
    scan = tuple(t.reshape(curve.rows, 4, 512).contiguous() for t in p)
    scan_aff = tuple(t.reshape(curve.rows, 4, 512).contiguous() for t in to_affine(curve, p)[:2])
    pairs = [
        (ec.scan_mixed(curve, *scan_aff), ec.scan_mixed_plain(curve, *scan_aff)),
        (ec.map_padd(curve, p, q), ec.map_padd_plain(curve, p, q)),
        (ec.map_pdouble(curve, p, times=5), ec.map_pdouble_plain(curve, p, times=5)),
        (ec.scan_proj(curve, *scan), ec.scan_proj_plain(curve, *scan)),
    ]
    for got, want in pairs:
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_msm_on_card_matches_oracle(dev):
    rng = random.Random(3)
    g = G1.pyref_spec.generator
    pts = [rng.randrange(1, C.R) * g for _ in range(300)]
    ks = [rng.randrange(C.R) for _ in range(300)]
    x, y, inf = prepare_points(G1, pts, dev)
    out = msm(G1, x, y, inf, torch.from_numpy(ints_to_limbs16(ks)).to(dev))
    want = G1.pyref_spec.identity_affine()
    for p_, k in zip(pts, ks):
        want = want + k * p_
    assert decode_points(G1, out)[0] == want
