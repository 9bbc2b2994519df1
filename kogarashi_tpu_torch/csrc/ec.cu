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
// maps take (W, C). W = 8 for G1, 16 for G2.
//
// Design: the TPU scan carried its accumulator across a sequential grid in
// VMEM scratch. Blocks on Hopper run in no order, so each chunk column c is
// one thread that loops over L with the accumulator in registers; thread c
// reads word k of position j at k*L*C + j*C + c, so a warp reads 32
// neighbouring words per load. The kernel masks its own ragged edge (no
// (8, 128) tiling, no L blocking).
//
// What bounds it on an H100: integer multiply throughput (a G1 padd is 12
// Montgomery multiplies, about 2k IMADs; a G2 padd 3x that) and registers,
// which cap how many threads an SM holds. Memory traffic is 3-6 coordinate
// reads and 3 writes per add, far below what the card streams. ptxas -v
// (CUDA 12.8, sm_90a), registers per thread, no spills anywhere:
//   G1: scan_mixed 108, scan_proj 136, map_padd 112, map_pdouble 92;
//   G2: scan_mixed 230, scan_proj 240, map_padd 232, map_pdouble 198
// (G2 calls one non-inlined base multiply, see field.cuh). chip_smoke.py's
// build phase prints these counts for the build it makes.

#include <cuda_runtime.h>

#include "field.cuh"

namespace kt {

template <class A>
struct Proj {
  typename A::E x, y, z;
};

// Curve constants: b3 = 3b in Montgomery form.
struct G1 {
  typedef Alg1<Fq> A;
  __device__ __forceinline__ static A::E b3() {
    A::E r;
    constexpr u32 v[8] = {0x410d7ff7u, 0xf60647ceu, 0xd31bd011u, 0x2f3d6f4du,
                          0x3940c6d1u, 0x2943337eu, 0xa7e39857u, 0x1d9598e8u};
#pragma unroll
    for (int j = 0; j < 8; j++) r.v[j] = v[j];
    return r;
  }
};

struct G2 {
  typedef Alg2<Fq> A;
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
  const E b3 = Cv::b3();
  E t0 = A::mul(p.x, q.x);
  E t1 = A::mul(p.y, q.y);
  E t2 = A::mul(p.z, q.z);
  E t3 = A::sub(A::sub(A::mul(A::add(p.x, p.y), A::add(q.x, q.y)), t0), t1);
  E t4 = A::sub(A::sub(A::mul(A::add(p.y, p.z), A::add(q.y, q.z)), t1), t2);
  E t5 = A::sub(A::sub(A::mul(A::add(p.x, p.z), A::add(q.x, q.z)), t0), t2);
  E t6 = A::add(A::add(t0, t0), t0);
  E t2b3 = A::mul(t2, b3);
  E zz = A::add(t1, t2b3);
  E tt = A::sub(t1, t2b3);
  E y5 = A::mul(t5, b3);
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
  const E b3 = Cv::b3();
  E t0 = A::mul(p.x, x2);
  E t1 = A::mul(p.y, y2);
  E t3 = A::sub(A::sub(A::mul(A::add(x2, y2), A::add(p.x, p.y)), t0), t1);
  E t4 = A::add(A::mul(y2, p.z), p.y);
  E t5 = A::add(A::mul(x2, p.z), p.x);
  E t6 = A::add(A::add(t0, t0), t0);
  E t2 = A::mul(b3, p.z);
  E zz = A::add(t1, t2);
  E tt = A::sub(t1, t2);
  E y5 = A::mul(b3, t5);
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
  const E b3 = Cv::b3();
  E t0 = A::sqr(p.y);
  E z8 = A::add(t0, t0);
  z8 = A::add(z8, z8);
  z8 = A::add(z8, z8);  // 8 y^2
  E t1 = A::mul(p.y, p.z);
  E t2 = A::mul(A::sqr(p.z), b3);
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

// K1 / K2: per-chunk inclusive prefix sums. One thread per chunk column.
template <class Cv, bool MIXED>
__global__ void scan_kernel(const u32* __restrict__ x, const u32* __restrict__ y,
                            const u32* __restrict__ z, u32* __restrict__ ox,
                            u32* __restrict__ oy, u32* __restrict__ oz, int L, int C) {
  typedef typename Cv::A A;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const size_t plane = (size_t)L * C;
  Proj<A> acc = identity<Cv>();
  for (int j = 0; j < L; j++) {
    const size_t off = (size_t)j * C + c;
    if (MIXED) {
      acc = madd<Cv>(acc, A::load(x, plane, off), A::load(y, plane, off));
    } else {
      Proj<A> q;
      q.x = A::load(x, plane, off);
      q.y = A::load(y, plane, off);
      q.z = A::load(z, plane, off);
      acc = padd<Cv>(acc, q);
    }
    A::store(ox, plane, off, acc.x);
    A::store(oy, plane, off, acc.y);
    A::store(oz, plane, off, acc.z);
  }
}

// K3: pointwise complete add of two (W, C) batches.
template <class Cv>
__global__ void padd_kernel(const u32* __restrict__ x1, const u32* __restrict__ y1,
                            const u32* __restrict__ z1, const u32* __restrict__ x2,
                            const u32* __restrict__ y2, const u32* __restrict__ z2,
                            u32* __restrict__ ox, u32* __restrict__ oy,
                            u32* __restrict__ oz, int C) {
  typedef typename Cv::A A;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
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
__global__ void pdouble_kernel(const u32* __restrict__ x, const u32* __restrict__ y,
                               const u32* __restrict__ z, u32* __restrict__ ox,
                               u32* __restrict__ oy, u32* __restrict__ oz, int C,
                               int times) {
  typedef typename Cv::A A;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
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

constexpr int kThreads = 128;

inline int blocks(int C) { return (C + kThreads - 1) / kThreads; }

}  // namespace kt

using namespace kt;

#define KT_EC_ENTRIES(NAME, CV)                                                         \
  extern "C" int kt_scan_mixed_##NAME(const void* x, const void* y, void* ox, void* oy, \
                                      void* oz, int L, int C, void* stream) {           \
    scan_kernel<CV, true><<<blocks(C), kThreads, 0, (cudaStream_t)stream>>>(            \
        (const u32*)x, (const u32*)y, nullptr, (u32*)ox, (u32*)oy, (u32*)oz, L, C);     \
    return (int)cudaGetLastError();                                                     \
  }                                                                                     \
  extern "C" int kt_scan_proj_##NAME(const void* x, const void* y, const void* z,       \
                                     void* ox, void* oy, void* oz, int L, int C,        \
                                     void* stream) {                                    \
    scan_kernel<CV, false><<<blocks(C), kThreads, 0, (cudaStream_t)stream>>>(           \
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
