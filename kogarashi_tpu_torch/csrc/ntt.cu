// N1: the radix-2 number-theoretic transform over BN254's Fr, for the
// H polynomial of the Groth16 prover (kogarashi_tpu_torch/ops/ntt.py).
//
// Replaces XLA code: kogarashi_tpu/ops/ntt.py::Domain (:39) runs its
// butterfly stages as whole-array jnp ops, with no Pallas kernel, and the
// port's plain version (ops/ntt.py `Domain._fft`) does the same in int64
// torch ops: per stage a 16-row CIOS multiply over the whole array, each
// stage reading and writing every element several times.
//
// The transform is the plain version's, butterfly for butterfly: bit-reverse
// the input, then decimation-in-time stages s = 0 .. k - 1 pairing positions
// p and p + 2^s (bit s of p clear) with the twiddle w^((p mod 2^s) 2^(k-1-s)),
// a' = a + t b, b' = a - t b, giving natural-order evaluations. Every value is
// canonical (field.cuh), so the words equal the plain version's.
//
// Passes. The k stages go in a few passes (ops/ntt.py `pass_plan`, a
// function of k alone): a pass covers stages [lo, lo + m), m <= 11, and each
// block loads a tile of J sub-transforms of 2^m elements (J 2^m <= 2^11
// elements, 64 KiB) into shared memory, runs the m stages there and writes
// the tile back. At k = 20 that is 2 passes of 10 stages, where the plain
// version makes 20 trips through device memory per multiply alone.
//   * First pass (lo = 0): the tile's J sub-transforms are the contiguous
//     blocks p = top 2^m + f whose bit-reversed tops rev(top) are J
//     consecutive numbers, so the bit reversal is folded into the load
//     addresses, x[rev_k(p)] = x[rev_m(f) 2^(k-m) + rev(top)]: for each f, J
//     consecutive words of each plane. It reads the input and writes the
//     output buffer.
//   * Later passes (lo > 0): positions p = top 2^(lo+m) + f 2^lo + c for J
//     consecutive columns c; stage s's twiddle index is then
//     ((f mod 2^r) 2^lo + c) 2^(k-1-s), r = s - lo. They run in place on the
//     output buffer: each block reads and writes only its own tile.
// Scalings are fused: coset_dft's g^i into the first pass's load (by the
// natural index read), idft's n^-1 and coset_idft's n^-1 g^-i into the last
// pass's store (a constant, or a table by output index). divide_by_z_on_coset
// is `ntt_scale_kernel`: one multiply by a constant per element.
//
// Layout: the port's words, (8, rows, n) int32 planes, the evaluation axis
// last; every row is its own transform, one grid for all rows. In shared
// memory the tile is kept as 8 planes too, so a warp's 32 loads of one word
// fall on 32 banks. The twiddle table (n/2 elements) and the scaling tables
// are element-major (count, 8): one element is 32 bytes, two 16-byte loads
// from one sector, read through the read-only cache.
//
// What bounds it on an H100: the Montgomery multiplies, 264 32-bit
// multiply-adds each (field.cuh) at 64 per SM per clock on 132 SMs. At
// (8, 3, 2^20), k = 20: 3 x 20 x 2^19 butterfly multiplies and 3 x 2^20
// scalings, about 0.54 ms at 1.98 GHz (ops/ntt.py `bound_ms`). Device memory:
// 2 passes x 2 x 96 MB at 3.35 TB/s, about 0.12 ms, and the later pass's
// twiddle reads (32 bytes a butterfly, from L2) under it. So the design
// spends nothing on memory beyond the two passes, keeps each element's 8
// words in registers through a butterfly, and leaves the multiply as the
// work: no lazy reductions (the bound argument of field.cuh holds as is).

#include <cuda_runtime.h>

#include "field.cuh"

namespace kt {

// The largest tile: 2^11 elements of 8 words, 64 KiB of dynamic shared
// memory (ops/ntt.py TILE_LOG).
constexpr int kNttTileLog = 11;
constexpr int kNttThreads = 256;

typedef Alg1<Fr> FrAlg;
typedef Elem<8> E8;

__device__ __forceinline__ u32 rev_bits(u32 x, int bits) {
  return bits ? __brev(x) >> (32 - bits) : 0u;
}

// element i of an element-major (count, 8) word table
__device__ __forceinline__ E8 table_elem(const uint4* __restrict__ t, size_t i) {
  const uint4 a = __ldg(t + 2 * i), b = __ldg(t + 2 * i + 1);
  E8 e;
  e.v[0] = a.x; e.v[1] = a.y; e.v[2] = a.z; e.v[3] = a.w;
  e.v[4] = b.x; e.v[5] = b.y; e.v[6] = b.z; e.v[7] = b.w;
  return e;
}

// One pass: stages [lo, lo + m) on tiles of 2^log_j sub-transforms of 2^m.
// pre (first pass) scales each input element by pre[i * pre_step], i its
// natural index; post (last pass) each output element by post[p * post_step].
__global__ void __launch_bounds__(kNttThreads)
ntt_pass_kernel(const u32* __restrict__ in, u32* __restrict__ out, const uint4* __restrict__ tw,
                const uint4* __restrict__ pre, int pre_step, const uint4* __restrict__ post,
                int post_step, int k, int lo, int m, int log_j) {
  extern __shared__ u32 sm[];
  const int log_t = m + log_j;
  const u32 T = 1u << log_t, J = 1u << log_j;
  const int log_groups = k - log_t;
  const size_t n = size_t(1) << k;
  const size_t plane = size_t(gridDim.x) << log_t;  // rows * n words
  const size_t row = blockIdx.x >> log_groups;
  const u32 g = blockIdx.x & ((1u << log_groups) - 1);
  const bool first = lo == 0;
  // later passes: the tile is columns c0 .. c0 + J - 1 under `top`
  const u32 top = first ? 0u : g >> (lo - log_j);
  const u32 c0 = first ? 0u : (g & ((1u << (lo - log_j)) - 1)) << log_j;
  const u32* __restrict__ src = (first ? in : out) + row * n;
  u32* __restrict__ dst = out + row * n;

  // the position of tile element (f, jj) in the array this pass writes
  auto position = [&](u32 f, u32 jj) -> u32 {
    return first ? (rev_bits((g << log_j) | jj, k - m) << m) | f
                 : (top << (lo + m)) | (f << lo) | (c0 + jj);
  };

  for (u32 li = threadIdx.x; li < T; li += blockDim.x) {
    const u32 f = li >> log_j, jj = li & (J - 1);
    const u32 i = first ? (rev_bits(f, m) << (k - m)) | ((g << log_j) | jj) : position(f, jj);
    E8 e = FrAlg::load<size_t>(src, plane, i);
    if (pre) e = FrAlg::mul(e, table_elem(pre, size_t(i) * pre_step));
#pragma unroll
    for (int w = 0; w < 8; w++) sm[w * T + li] = e.v[w];
  }
  __syncthreads();

  for (int r = 0; r < m; r++) {
    const u32 half = 1u << r;
    const int shift = k - 1 - lo - r;
    for (u32 b = threadIdx.x; b < T / 2; b += blockDim.x) {
      const u32 jj = b & (J - 1), hb = b >> log_j;
      const u32 low = hb & (half - 1);
      const u32 ia = ((((hb >> r) << (r + 1)) | low) << log_j) | jj;
      const u32 ib = ia + (half << log_j);
      const u32 col = first ? 0u : c0 + jj;
      const E8 t = table_elem(tw, size_t((low << lo) | col) << shift);
      E8 u, v;
#pragma unroll
      for (int w = 0; w < 8; w++) {
        u.v[w] = sm[w * T + ia];
        v.v[w] = sm[w * T + ib];
      }
      v = FrAlg::mul(v, t);
      const E8 s = FrAlg::add(u, v), d = FrAlg::sub(u, v);
#pragma unroll
      for (int w = 0; w < 8; w++) {
        sm[w * T + ia] = s.v[w];
        sm[w * T + ib] = d.v[w];
      }
    }
    __syncthreads();
  }

  for (u32 li = threadIdx.x; li < T; li += blockDim.x) {
    const u32 f = li >> log_j, jj = li & (J - 1);
    const u32 p = position(f, jj);
    E8 e;
#pragma unroll
    for (int w = 0; w < 8; w++) e.v[w] = sm[w * T + li];
    if (post) e = FrAlg::mul(e, table_elem(post, size_t(p) * post_step));
    FrAlg::store<size_t>(dst, plane, p, e);
  }
}

// out = in * c, c one element; `plane` words a plane.
__global__ void ntt_scale_kernel(const u32* __restrict__ in, u32* __restrict__ out,
                                 const uint4* __restrict__ c, size_t plane) {
  const size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= plane) return;
  const E8 e = FrAlg::load<size_t>(in, plane, i);
  FrAlg::store<size_t>(out, plane, i, FrAlg::mul(e, table_elem(c, 0)));
}

}  // namespace kt

using namespace kt;

// One pass over `rows` transforms of 2^k (ops/ntt.py `Domain._launch`).
// Refuses a plan the kernel does not take: a tile over kNttTileLog, a pass
// outside [0, k), later passes' columns beyond 2^lo.
extern "C" int kt_ntt_pass_fr(const void* in, void* out, const void* tw, const void* pre,
                              int pre_step, const void* post, int post_step, long long rows,
                              int k, int lo, int m, int log_j, void* stream) {
  const int log_t = m + log_j;
  if (k < 1 || k > 28 || m < 1 || log_j < 0 || log_t > kNttTileLog || log_t > k || lo < 0 ||
      lo + m > k || (lo > 0 && log_j > lo) || rows < 1)
    return (int)cudaErrorInvalidValue;
  const long long blocks = rows << (k - log_t);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = size_t(32) << log_t;
  cudaError_t err = cudaFuncSetAttribute(ntt_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(size_t(32) << kNttTileLog));
  if (err != cudaSuccess) return (int)err;
  const int threads = log_t - 1 >= 8 ? kNttThreads : 1 << (log_t - 1);
  ntt_pass_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      (const u32*)in, (u32*)out, (const uint4*)tw, (const uint4*)pre, pre_step, (const uint4*)post,
      post_step, k, lo, m, log_j);
  return (int)cudaGetLastError();
}

// out = in * c over (8, plane) words; c one element (count 1, 8 words).
extern "C" int kt_ntt_scale_fr(const void* in, void* out, const void* c, long long plane,
                               void* stream) {
  if (plane < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = (plane + 255) / 256;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ntt_scale_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      (const u32*)in, (u32*)out, (const uint4*)c, (size_t)plane);
  return (int)cudaGetLastError();
}
