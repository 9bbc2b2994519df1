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


# ---------------------------------------------------------------------------
# N1's pass plan and index arithmetic (csrc/ntt.cu), on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", range(1, FR.s + 1))
def test_pass_plan_covers_k_stages(k):
    plan = ntt.pass_plan(k)
    assert [lo for lo, _, _ in plan] == [sum(m for _, m, _ in plan[:i]) for i in range(len(plan))]
    assert sum(m for _, m, _ in plan) == k
    assert len(plan) == -(-k // ntt.TILE_LOG)
    for lo, m, log_j in plan:
        assert m >= 1 and log_j >= 0
        assert 32 << (m + log_j) <= ntt.SMEM_BYTES  # 8 words of 4 bytes an element
        assert m + log_j <= k  # a tile lies within one transform
        if lo:
            assert log_j <= lo  # the tile's columns lie below 2^lo


def _rev(x, bits):
    return int(format(x, f"0{bits}b")[::-1], 2) if bits else 0


def _emulate_n1(k, vals, root, tile_log, pre=None, post=None):
    """csrc/ntt.cu's passes over one row, on standard-form ints: the same
    plan, tile addresses, butterflies and twiddle indices as the kernel."""
    p, n = FR.p, 1 << k
    tw = [pow(root, e, p) for e in range(n // 2)]
    out = [None] * n
    plan = ntt.pass_plan(k, tile_log)
    for lo, m, log_j in plan:
        first, last = lo == 0, lo + m == k
        J, T = 1 << log_j, 1 << (m + log_j)
        for g in range(n // T):
            top = 0 if first else g >> (lo - log_j)
            c0 = 0 if first else (g & ((1 << (lo - log_j)) - 1)) << log_j

            def position(f, jj):
                if first:
                    return (_rev((g << log_j) | jj, k - m) << m) | f
                return (top << (lo + m)) | (f << lo) | (c0 + jj)

            tile = []
            for li in range(T):
                f, jj = li >> log_j, li & (J - 1)
                if first:
                    i = (_rev(f, m) << (k - m)) | (g << log_j) | jj
                    tile.append(vals[i] * (pre[i] if pre else 1) % p)
                else:
                    tile.append(out[position(f, jj)])
            for r in range(m):
                half = 1 << r
                for b in range(T // 2):
                    jj, hb = b & (J - 1), b >> log_j
                    low = hb & (half - 1)
                    ia = ((((hb >> r) << (r + 1)) | low) << log_j) | jj
                    ib = ia + (half << log_j)
                    col = 0 if first else c0 + jj
                    v = tile[ib] * tw[((low << lo) | col) << (k - 1 - lo - r)] % p
                    tile[ia], tile[ib] = (tile[ia] + v) % p, (tile[ia] - v) % p
            for li in range(T):
                f, jj = li >> log_j, li & (J - 1)
                q = position(f, jj)
                out[q] = tile[li] * (post[q] if post and last else 1) % p
    return out


@pytest.mark.parametrize("tile_log", [2, 3, ntt.TILE_LOG])
@pytest.mark.parametrize("k", [1, 3, 5, 7])
def test_n1_index_arithmetic_matches_plain(k, tile_log):
    """The kernel's passes, emulated on ints with tiles of 2^tile_log (small
    tiles force several passes at small k), equal the plain Domain."""
    p, n = FR.p, 1 << k
    dom = ntt.Domain(k, device="cpu")
    w = pow(FR.root_of_unity, 1 << (FR.s - k), p)
    g, n_inv = FR.generator, pow(n, -1, p)
    cosets = [pow(g, i, p) for i in range(n)]
    inv_cosets_n_inv = [pow(g, -i, p) * n_inv % p for i in range(n)]
    vals = [0, 1, p - 1][:n] + _vals(n, 5)[: max(0, n - 3)]
    runs = {
        "dft": _emulate_n1(k, vals, w, tile_log),
        "idft": _emulate_n1(k, vals, pow(w, -1, p), tile_log, post=[n_inv] * n),
        "coset_dft": _emulate_n1(k, vals, w, tile_log, pre=cosets),
        "coset_idft": _emulate_n1(k, vals, pow(w, -1, p), tile_log, post=inv_cosets_n_inv),
    }
    x = torch.from_numpy(FR.encode(vals))
    for method, got in runs.items():
        assert got == FR.decode(getattr(dom, method)(x).numpy()), method
