"""Port NTT and SpMV (plain torch) against the JAX package's `ops/ntt.py`
Domain and `ops/spmv.py`, run eagerly, on the same inputs. Exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kogarashi_tpu.fields.spec import FR as JFR
from kogarashi_tpu.ops import ntt as jntt
from kogarashi_tpu.ops import spmv as jspmv
from kogarashi_tpu.r1cs.vector import SquareChainCircuit
from kogarashi_tpu_torch import interop
from kogarashi_tpu_torch.fields.spec import FR
from kogarashi_tpu_torch.ops import ntt, spmv

torch.set_num_threads(2)  # the suite runs several workers side by side

K = 4


def _vals(n, seed):
    raw = np.random.default_rng(seed).integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    return [int.from_bytes(r.astype("<u4").tobytes(), "little") % FR.p for r in raw]


@pytest.mark.parametrize("op", ["dft", "idft", "coset_dft", "coset_idft", "divide_by_z_on_coset"])
def test_domain_matches_jax(op):
    rows = [_vals(1 << K, 1), _vals(1 << K, 2)]  # a batch axis, as the prover stacks A, B, C
    words = torch.stack([torch.from_numpy(FR.encode(r)) for r in rows], dim=1)  # (8, 2, n)
    jarr = jnp.stack([jnp.asarray(JFR.encode(r).T) for r in rows], axis=1)  # (16, 2, n)
    got = getattr(ntt.Domain(K, device="cpu"), op)(words)
    with jax.disable_jit():
        want = getattr(jntt.Domain(K), op)(jarr)
    assert np.array_equal(got.numpy(), interop.words_from_limbs16(np.asarray(want)))


def test_domain_roundtrip():
    dom = ntt.Domain(K, device="cpu")
    x = torch.from_numpy(FR.encode(_vals(1 << K, 3)))
    assert torch.equal(dom.idft(dom.dft(x)), x)
    assert torch.equal(dom.coset_idft(dom.coset_dft(x)), x)


@pytest.mark.parametrize("transposed", [False, True], ids=["matvec", "transposed"])
def test_spmv_matches_jax(transposed):
    cs = SquareChainCircuit(16).build()
    mats = spmv.r1cs_matrices(cs, FR, "cpu")
    jmats = jspmv.r1cs_matrices_device(cs, JFR)
    n_out, n_in = (cs.l() + cs.m_l_1(), cs.m) if transposed else (cs.m, cs.l() + cs.m_l_1())
    vec = _vals(n_in, 4)
    for mat, jmat in zip(mats, jmats):
        assert np.array_equal(mat["coeff"].numpy(), interop.words_from_limbs16(np.asarray(jmat["coeff"])))
        f, jf = (spmv.transposed_matvec, jspmv.transposed_matvec) if transposed else (spmv.matvec, jspmv.matvec)
        got = f(mat, torch.from_numpy(FR.encode(vec)), n_out, FR)
        with jax.disable_jit():
            want = jf(jmat, jnp.asarray(JFR.encode(vec).T), n_out, JFR)
        assert np.array_equal(got.numpy(), interop.words_from_limbs16(np.asarray(want)))
