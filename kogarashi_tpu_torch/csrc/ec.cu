// Batched short-Weierstrass point kernels (BN254 G1 over Fq, G2 over Fq2).
//
// Replaces the four Pallas TPU kernels of kogarashi_tpu/ops/ec_pallas.py:
//   K1 scan_mixed  <- `_scan_call(mixed=True)`  (:336, body `_scan_kernel` :297)
//   K2 scan_proj   <- `_scan_call(mixed=False)` (:336, entry `scan_proj` :427)
//   K3 map_padd    <- `_map_call(op="padd")`    (:453, body `_map_kernel` :435)
//   K4 map_pdouble <- `_map_call(op="pdouble:t")` (:453, entry :487)
// Formulas are the complete RCB16 ones for a = 0 (eprint 2015/1060, Alg 7
// padd, Alg 8 madd, Alg 9 pdouble), identity (0:1:0), branchless, the same
// sequence as kogarashi_tpu/pyref/curve.py and the plain versions in
// kogarashi_tpu_torch/ops/ec.py. Field ops are canonical (field.cuh), so a
// kernel's output equals its plain version's bit for bit.
//
// Layout: coordinates are int32 word planes, limb-major. Scans take
// (W, L, C) arrays (word k, scan position j, chunk c at k*L*C + j*C + c);
// maps take (W, C). W = 8 for G1, 16 for G2. Thread c touches word k of
// lane c at k*plane + c, so each of a warp's loads and stores covers 32
// neighbouring words (128 bytes): every coordinate access is coalesced.
//
// What bounds them (ops/ec.py `bound_ms` computes it per shape): 32-bit
// integer multiply-adds. A Montgomery multiply is 264 of them (field.cuh);
// a G1 madd is 11 multiplies, padd 12, pdouble 8 (the b3 products of G1 are
// adds, below); an Fq2 multiply is 3 base multiplies and G2's b3 products
// stay multiplies. At NVIDIA's 64 per SM per clock on 132 SMs (csrc/
// imad_probe.cu measures what the card issues) the card's floor is far above
// its memory floor: K1 G1 at (8, 128, 131072) is 2.9 ms of multiply-adds
// against 0.8 ms of bytes.
//
// b3: G1 has b = 3, so b3 = 3b = 9 and 9x = 8x + x is three modular
// doublings and one add (`G1::mul_b3`), the same canonical element as the
// multiply by 9R it replaces. G2's b3 is a general Fq2 constant.
//
// Per kernel: design, and ptxas -v (nvcc 12.9, sm_90a) registers per thread
// as G1 / G2; no kernel spills, no stack. chip_smoke.py's build phase prints
// them for the build it makes.
//   K1 scan_mixed (replaces `_scan_call(mixed=True)`): one thread per chunk
//     column, the accumulator in registers over L steps; 11 (G1) or 39 (G2)
//     multiplies a step. Step j + 1's affine point (2W words) is fetched with
//     cp.async into a two-stage ring in shared memory, [stage][word][thread]
//     (no bank conflicts), while step j's madd runs, so the load does not
//     stall the warp (a small gain, PERF.md). All L prefix sums are written: the
//     bucket-endpoint gather (ops/msm.py) reads them. 150 / 232 registers, so
//     3 / 2 blocks of 128 per SM: 1024 blocks at C = 131072 are 2.59 / 3.88
//     waves. SASS (G1): 2800 instructions a step, 1326 of them IMAD.WIDE
//     (two multiply-adds each) and 182 other IMAD.
//   K2 scan_proj (replaces `_scan_call(mixed=False)`): K1's loop with a
//     projective point and padd (12 / 42 multiplies), no prefetch.
//     153 / 252 registers.
//   K3 map_padd (replaces `_map_call("padd")`): one thread per lane, six
//     coordinate loads, padd (12 / 42 multiplies), three stores. 128 / 248
//     registers, 4 / 2 blocks per SM; (rows, 2^20) is 8192 blocks, 15.5 / 31
//     waves. SASS (G1): 3056 instructions.
//   K4 map_pdouble (replaces `_map_call("pdouble:t")`): `times` doublings per
//     thread (8 / 25 multiplies each). 108 / 198 registers.

#include <cuda_runtime.h>

#include "field.cuh"

namespace kt {

constexpr int kThreads = 128;

// Blocks of kThreads that one SM must be able to hold (__launch_bounds__'s
// second argument), so registers per thread stay <= 65536 / (128 * blocks).
// Maps (K3, K4): G1 4 blocks, <= 128 registers, 16 warps per SM; G2 2 blocks
// (<= 255 registers), 8 warps. Scans (K1, K2): 1, no cap, because at G1's
// 128-register cap both spilled; they take the registers they need and the
// SM holds what fits. Measured (PERF.md): between 12 and 20 warps per SM,
// and with the last of the scan's 1024 blocks' waves 59% to 94% full, K1
// and K3 hardly move.

template <class A>
struct Proj {
  typename A::E x, y, z;
};

struct G1 {
  typedef Alg1<Fq> A;
  static constexpr int W = 8;
  static constexpr int kMinBlocks = 4;
  static constexpr int kScanMinBlocks = 1;
  // 9x = 8x + x
  __device__ __forceinline__ static A::E mul_b3(const A::E& x) {
    A::E x2 = A::add(x, x);
    A::E x4 = A::add(x2, x2);
    return A::add(A::add(x4, x4), x);
  }
};

struct G2 {
  typedef Alg2<Fq> A;
  static constexpr int W = 16;
  static constexpr int kMinBlocks = 2;
  static constexpr int kScanMinBlocks = 1;
  // b3 = 3b in Montgomery form
  __device__ __forceinline__ static A::E b3() {
    A::E r;
    constexpr u32 v[16] = {0xb62e0d6au, 0x3baa927cu, 0xd1b664fdu, 0xd71e7c52u,
                           0xd95d4664u, 0x03873e63u, 0x082ab8f4u, 0x0e75b5b1u,
                           0x7596fe35u, 0xaab7c666u, 0xbb6a27bau, 0x31d21a78u,
                           0x680401ffu, 0x85dd7297u, 0xdf39a7e9u, 0x03c52d6au};
#pragma unroll
    for (int j = 0; j < 8; j++) {
      r.c0.v[j] = v[j];
      r.c1.v[j] = v[j + 8];
    }
    return r;
  }
  __device__ __forceinline__ static A::E mul_b3(const A::E& x) { return A::mul(x, b3()); }
};

template <class Cv>
__device__ __forceinline__ Proj<typename Cv::A> identity() {
  typedef typename Cv::A A;
  Proj<A> r;
  r.x = A::zero();
  r.y = A::one();
  r.z = A::zero();
  return r;
}

// RCB16 Alg 7, a = 0.
template <class Cv>
__device__ __forceinline__ Proj<typename Cv::A> padd(const Proj<typename Cv::A>& p,
                                                     const Proj<typename Cv::A>& q) {
  typedef typename Cv::A A;
  typedef typename A::E E;
  E t0 = A::mul(p.x, q.x);
  E t1 = A::mul(p.y, q.y);
  E t2 = A::mul(p.z, q.z);
  E t3 = A::sub(A::sub(A::mul(A::add(p.x, p.y), A::add(q.x, q.y)), t0), t1);
  E t4 = A::sub(A::sub(A::mul(A::add(p.y, p.z), A::add(q.y, q.z)), t1), t2);
  E t5 = A::sub(A::sub(A::mul(A::add(p.x, p.z), A::add(q.x, q.z)), t0), t2);
  E t6 = A::add(A::add(t0, t0), t0);
  E t2b3 = Cv::mul_b3(t2);
  E zz = A::add(t1, t2b3);
  E tt = A::sub(t1, t2b3);
  E y5 = Cv::mul_b3(t5);
  Proj<A> r;
  r.x = A::sub(A::mul(t3, tt), A::mul(t4, y5));
  r.y = A::add(A::mul(y5, t6), A::mul(tt, zz));
  r.z = A::add(A::mul(zz, t4), A::mul(t6, t3));
  return r;
}

// RCB16 Alg 8, a = 0: projective p + affine (x2, y2).
template <class Cv>
__device__ __forceinline__ Proj<typename Cv::A> madd(const Proj<typename Cv::A>& p,
                                                     const typename Cv::A::E& x2,
                                                     const typename Cv::A::E& y2) {
  typedef typename Cv::A A;
  typedef typename A::E E;
  E t0 = A::mul(p.x, x2);
  E t1 = A::mul(p.y, y2);
  E t3 = A::sub(A::sub(A::mul(A::add(x2, y2), A::add(p.x, p.y)), t0), t1);
  E t4 = A::add(A::mul(y2, p.z), p.y);
  E t5 = A::add(A::mul(x2, p.z), p.x);
  E t6 = A::add(A::add(t0, t0), t0);
  E t2 = Cv::mul_b3(p.z);
  E zz = A::add(t1, t2);
  E tt = A::sub(t1, t2);
  E y5 = Cv::mul_b3(t5);
  Proj<A> r;
  r.x = A::sub(A::mul(t3, tt), A::mul(t4, y5));
  r.y = A::add(A::mul(y5, t6), A::mul(tt, zz));
  r.z = A::add(A::mul(zz, t4), A::mul(t6, t3));
  return r;
}

// RCB16 Alg 9, a = 0.
template <class Cv>
__device__ __forceinline__ Proj<typename Cv::A> pdouble(const Proj<typename Cv::A>& p) {
  typedef typename Cv::A A;
  typedef typename A::E E;
  E t0 = A::sqr(p.y);
  E z8 = A::add(t0, t0);
  z8 = A::add(z8, z8);
  z8 = A::add(z8, z8);  // 8 y^2
  E t1 = A::mul(p.y, p.z);
  E t2 = Cv::mul_b3(A::sqr(p.z));
  E x3 = A::mul(t2, z8);
  E y3 = A::add(t0, t2);
  Proj<A> r;
  r.z = A::mul(t1, z8);
  E t2x3 = A::add(A::add(t2, t2), t2);
  t0 = A::sub(t0, t2x3);
  r.y = A::add(A::mul(t0, y3), x3);
  E xy = A::mul(p.x, p.y);
  E xf = A::mul(t0, xy);
  r.x = A::add(xf, xf);
  return r;
}

// 4-byte asynchronous copy global -> shared, and its group fences.
__device__ __forceinline__ void cp_async4(u32* smem, const u32* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// K1: per-chunk inclusive prefix sums of affine points, prefetched one step
// ahead through a two-stage shared-memory ring.
template <class Cv>
__global__ void __launch_bounds__(kThreads, Cv::kScanMinBlocks)
    scan_mixed_kernel(const u32* __restrict__ x, const u32* __restrict__ y,
                      u32* __restrict__ ox, u32* __restrict__ oy, u32* __restrict__ oz,
                      int L, int C) {
  typedef typename Cv::A A;
  constexpr int W = Cv::W;
  __shared__ u32 ring[2][2 * W][kThreads];
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const size_t plane = (size_t)L * C;
  auto fetch = [&](int j) {
    const size_t off = (size_t)j * C + c;
    u32(*slot)[kThreads] = ring[j & 1];
#pragma unroll
    for (int k = 0; k < W; k++) {
      cp_async4(&slot[k][threadIdx.x], x + k * plane + off);
      cp_async4(&slot[W + k][threadIdx.x], y + k * plane + off);
    }
    cp_async_commit();
  };
  fetch(0);
  Proj<A> acc = identity<Cv>();
  for (int j = 0; j < L; j++) {
    if (j + 1 < L) {
      fetch(j + 1);
      cp_async_wait<1>();  // step j's copies are done; step j + 1's may fly
    } else {
      cp_async_wait<0>();
    }
    const u32* slot = &ring[j & 1][0][threadIdx.x];
    acc = madd<Cv>(acc, A::load(slot, kThreads, 0), A::load(slot + W * kThreads, kThreads, 0));
    const size_t off = (size_t)j * C + c;
    A::store(ox, plane, off, acc.x);
    A::store(oy, plane, off, acc.y);
    A::store(oz, plane, off, acc.z);
  }
}

// K2: per-chunk inclusive prefix sums of projective points.
template <class Cv>
__global__ void __launch_bounds__(kThreads, Cv::kScanMinBlocks)
    scan_proj_kernel(const u32* __restrict__ x, const u32* __restrict__ y,
                     const u32* __restrict__ z, u32* __restrict__ ox, u32* __restrict__ oy,
                     u32* __restrict__ oz, int L, int C) {
  typedef typename Cv::A A;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const size_t plane = (size_t)L * C;
  Proj<A> acc = identity<Cv>();
  for (int j = 0; j < L; j++) {
    const size_t off = (size_t)j * C + c;
    Proj<A> q;
    q.x = A::load(x, plane, off);
    q.y = A::load(y, plane, off);
    q.z = A::load(z, plane, off);
    acc = padd<Cv>(acc, q);
    A::store(ox, plane, off, acc.x);
    A::store(oy, plane, off, acc.y);
    A::store(oz, plane, off, acc.z);
  }
}

// K3: pointwise complete add of two (W, C) batches.
template <class Cv>
__global__ void __launch_bounds__(kThreads, Cv::kMinBlocks)
    padd_kernel(const u32* __restrict__ x1, const u32* __restrict__ y1,
                const u32* __restrict__ z1, const u32* __restrict__ x2,
                const u32* __restrict__ y2, const u32* __restrict__ z2,
                u32* __restrict__ ox, u32* __restrict__ oy, u32* __restrict__ oz, int C) {
  typedef typename Cv::A A;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  Proj<A> p, q;
  p.x = A::load(x1, C, c);
  p.y = A::load(y1, C, c);
  p.z = A::load(z1, C, c);
  q.x = A::load(x2, C, c);
  q.y = A::load(y2, C, c);
  q.z = A::load(z2, C, c);
  Proj<A> r = padd<Cv>(p, q);
  A::store(ox, C, c, r.x);
  A::store(oy, C, c, r.y);
  A::store(oz, C, c, r.z);
}

// K4: `times` complete doublings in a row, fused.
template <class Cv>
__global__ void __launch_bounds__(kThreads, Cv::kMinBlocks)
    pdouble_kernel(const u32* __restrict__ x, const u32* __restrict__ y,
                   const u32* __restrict__ z, u32* __restrict__ ox, u32* __restrict__ oy,
                   u32* __restrict__ oz, int C, int times) {
  typedef typename Cv::A A;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  Proj<A> p;
  p.x = A::load(x, C, c);
  p.y = A::load(y, C, c);
  p.z = A::load(z, C, c);
  for (int t = 0; t < times; t++) p = pdouble<Cv>(p);
  A::store(ox, C, c, p.x);
  A::store(oy, C, c, p.y);
  A::store(oz, C, c, p.z);
}

inline int blocks(int C) { return (C + kThreads - 1) / kThreads; }

}  // namespace kt

using namespace kt;

#define KT_EC_ENTRIES(NAME, CV)                                                         \
  extern "C" int kt_scan_mixed_##NAME(const void* x, const void* y, void* ox, void* oy, \
                                      void* oz, int L, int C, void* stream) {           \
    scan_mixed_kernel<CV><<<blocks(C), kThreads, 0, (cudaStream_t)stream>>>(            \
        (const u32*)x, (const u32*)y, (u32*)ox, (u32*)oy, (u32*)oz, L, C);              \
    return (int)cudaGetLastError();                                                     \
  }                                                                                     \
  extern "C" int kt_scan_proj_##NAME(const void* x, const void* y, const void* z,       \
                                     void* ox, void* oy, void* oz, int L, int C,        \
                                     void* stream) {                                    \
    scan_proj_kernel<CV><<<blocks(C), kThreads, 0, (cudaStream_t)stream>>>(             \
        (const u32*)x, (const u32*)y, (const u32*)z, (u32*)ox, (u32*)oy, (u32*)oz, L,   \
        C);                                                                             \
    return (int)cudaGetLastError();                                                     \
  }                                                                                     \
  extern "C" int kt_map_padd_##NAME(const void* x1, const void* y1, const void* z1,     \
                                    const void* x2, const void* y2, const void* z2,     \
                                    void* ox, void* oy, void* oz, int C, void* stream) { \
    padd_kernel<CV><<<blocks(C), kThreads, 0, (cudaStream_t)stream>>>(                  \
        (const u32*)x1, (const u32*)y1, (const u32*)z1, (const u32*)x2, (const u32*)y2, \
        (const u32*)z2, (u32*)ox, (u32*)oy, (u32*)oz, C);                               \
    return (int)cudaGetLastError();                                                     \
  }                                                                                     \
  extern "C" int kt_map_pdouble_##NAME(const void* x, const void* y, const void* z,     \
                                       void* ox, void* oy, void* oz, int C, int times,  \
                                       void* stream) {                                  \
    pdouble_kernel<CV><<<blocks(C), kThreads, 0, (cudaStream_t)stream>>>(               \
        (const u32*)x, (const u32*)y, (const u32*)z, (u32*)ox, (u32*)oy, (u32*)oz, C,   \
        times);                                                                         \
    return (int)cudaGetLastError();                                                     \
  }

KT_EC_ENTRIES(g1, G1)
KT_EC_ENTRIES(g2, G2)
