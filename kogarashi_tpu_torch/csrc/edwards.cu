// Batched twisted-Edwards (a = -1) point kernels for Jubjub over BLS12-381's
// scalar field (field.cuh `BlsFr`): RedDSA batch verification's device work.
//
// These replace XLA programs, not Pallas kernels: the JAX package runs the
// Edwards ops as jitted jnp code (no Pallas kernel exists for them).
//   E1 ed_scalar_mul  <- kogarashi_tpu/curves/edwards.py:110 `scalar_mul`, a
//                        256-step lax.scan under jax.jit, one device loop
//   E2 ed_map_add     <- :77 `eadd` (edwards.rs:74-95), with :67 `eneg` of
//                        the second operand folded in by a flag
//   E3 ed_map_double  <- :96 `edouble` (edwards.rs:99-116), `times` in a row
// The port's plain field engine would run E1's 256 steps as some 2 million
// torch launches a call; E1 is the one loop on the card that XLA made of it.
//
// Formulas: the unified extended-coordinate ones for a = -1, complete since
// d is a non-square, so every op is branchless; identity (0 : 1 : 0 : 1).
// eadd is 9 multiplies and the multiply by d, edouble 4 multiplies and 3
// squares; the negations of a = -1 are canonical subtracts from 0. Field ops
// are canonical (field.cuh, whose bound argument covers BlsFr, p < 2^255), so
// every output equals the plain version's (ops/edwards.py) bit for bit.
//
// Layout: a point is four int32 word planes (X, Y, T, Z), each (8, n), word
// k of lane c at k * n + c, so each of a warp's loads and stores covers 32
// neighbouring words. Scalars are (16, n) int32 standard-form 16-bit limbs,
// the JAX package's `ints_to_limbs(...).T`; any 256-bit value is taken.
//
// What bounds them (ops/edwards.py `bound_ms`): 32-bit integer multiply-adds,
// 264 per Montgomery multiply (field.cuh), at NVIDIA's 64 per SM per clock on
// 132 SMs. E1 is 256 x 17 multiplies a lane; E2 10, E3 7 per doubling.
//   E1 ed_scalar_mul: one thread per lane, MSB-first double-and-add over all
//     256 bits as JAX's scan runs it: the add is always computed and the bit
//     selects (SEL, no branch on the data). The accumulator and the base
//     stay in registers; the base is one broadcast point (pn = 1) or one per
//     lane (pn = n). Each 16-bit limb of k is read once, when its bits start.
//     At the signature path's 2048-16384 lanes the launch is 16-128 blocks of
//     128: fewer warps than the card has schedulers, so a lane's chain of
//     dependent multiplies, not the issue rate, sets its time. Spreading a
//     lane over a group of threads (as K4 does, csrc/ec.cu) is left for a
//     later change.
//   E2 ed_map_add, E3 ed_map_double: one thread per lane, loads, the op(s),
//     stores; at 2^16 lanes the issue rate bounds them.
// chip_smoke.py's build phase prints each kernel's registers and spills.

#include <cuda_runtime.h>

#include "field.cuh"

namespace kt {

constexpr int kEdThreads = 128;

// Jubjub: -x^2 + y^2 = 1 + d x^2 y^2 over BLS12-381's Fr.
struct Jubjub {
  typedef Alg1<BlsFr> A;
  // d = -(10240/10241) in Montgomery form
  __device__ __forceinline__ static A::E d() {
    A::E r;
    constexpr u32 v[8] = {0xb974f6b0u, 0x2a522455u, 0x0d9acab3u, 0xfc6cc9efu,
                          0xc27628d1u, 0x7a08fb94u, 0xfe0e262eu, 0x57f8f6a8u};
#pragma unroll
    for (int j = 0; j < 8; j++) r.v[j] = v[j];
    return r;
  }
};

template <class A>
struct Ext {
  typename A::E x, y, t, z;
};

template <class Cv>
__device__ __forceinline__ Ext<typename Cv::A> ed_identity() {
  typedef typename Cv::A A;
  Ext<A> r;
  r.x = A::zero();
  r.y = A::one();
  r.t = A::zero();
  r.z = A::one();
  return r;
}

// Extended + extended (edwards.rs:74-95): 9 multiplies and one by d.
template <class Cv>
__device__ __forceinline__ Ext<typename Cv::A> eadd(const Ext<typename Cv::A>& p,
                                                    const Ext<typename Cv::A>& q) {
  typedef typename Cv::A A;
  typedef typename A::E E;
  const E aa = A::mul(p.x, q.x);
  const E bb = A::mul(p.y, q.y);
  const E cc = A::mul(Cv::d(), A::mul(p.t, q.t));
  const E dd = A::mul(p.z, q.z);
  const E h = A::add(aa, bb);
  const E e = A::sub(A::mul(A::add(p.x, p.y), A::add(q.x, q.y)), h);
  const E f = A::sub(dd, cc);
  const E g = A::add(dd, cc);
  Ext<A> r;
  r.x = A::mul(e, f);
  r.y = A::mul(g, h);
  r.t = A::mul(e, h);
  r.z = A::mul(f, g);
  return r;
}

// Extended doubling, a = -1 (edwards.rs:99-116): 4 multiplies, 3 squares.
template <class Cv>
__device__ __forceinline__ Ext<typename Cv::A> edouble(const Ext<typename Cv::A>& p) {
  typedef typename Cv::A A;
  typedef typename A::E E;
  const E aa = A::sub(A::zero(), A::sqr(p.x));
  const E bb = A::sqr(p.y);
  const E zz = A::sqr(p.z);
  const E cc = A::add(zz, zz);
  const E dd = A::sub(aa, bb);
  const E xy = A::mul(p.x, p.y);
  const E e = A::add(xy, xy);
  const E g = A::add(aa, bb);
  const E f = A::sub(g, cc);
  Ext<A> r;
  r.x = A::mul(e, f);
  r.y = A::mul(g, dd);
  r.t = A::mul(e, dd);
  r.z = A::mul(f, g);
  return r;
}

template <class A>
__device__ __forceinline__ Ext<A> ed_load(const u32* __restrict__ x, const u32* __restrict__ y,
                                          const u32* __restrict__ t, const u32* __restrict__ z,
                                          int plane, int c) {
  Ext<A> p;
  p.x = A::load(x, plane, c);
  p.y = A::load(y, plane, c);
  p.t = A::load(t, plane, c);
  p.z = A::load(z, plane, c);
  return p;
}

template <class A>
__device__ __forceinline__ void ed_store(u32* __restrict__ x, u32* __restrict__ y,
                                         u32* __restrict__ t, u32* __restrict__ z, int plane,
                                         int c, const Ext<A>& p) {
  A::store(x, plane, c, p.x);
  A::store(y, plane, c, p.y);
  A::store(t, plane, c, p.t);
  A::store(z, plane, c, p.z);
}

// E1: [k]P per lane, MSB first over 256 bits, the add selected by the bit.
template <class Cv>
__global__ void __launch_bounds__(kEdThreads, 1)
    ed_scalar_mul_kernel(const u32* __restrict__ px, const u32* __restrict__ py,
                         const u32* __restrict__ pt, const u32* __restrict__ pz, int pn,
                         const u32* __restrict__ k, u32* __restrict__ ox, u32* __restrict__ oy,
                         u32* __restrict__ ot, u32* __restrict__ oz, int n) {
  typedef typename Cv::A A;
  const int c = blockIdx.x * kEdThreads + threadIdx.x;
  if (c >= n) return;
  const Ext<A> p = ed_load<A>(px, py, pt, pz, pn, pn == 1 ? 0 : c);
  Ext<A> acc = ed_identity<Cv>();
#pragma unroll 1
  for (int l = 15; l >= 0; l--) {
    const u32 limb = k[(size_t)l * n + c];
#pragma unroll 1
    for (int b = 15; b >= 0; b--) {
      acc = edouble<Cv>(acc);
      const Ext<A> s = eadd<Cv>(acc, p);
      const bool bit = (limb >> b) & 1u;
#pragma unroll
      for (int w = 0; w < 8; w++) {
        acc.x.v[w] = bit ? s.x.v[w] : acc.x.v[w];
        acc.y.v[w] = bit ? s.y.v[w] : acc.y.v[w];
        acc.t.v[w] = bit ? s.t.v[w] : acc.t.v[w];
        acc.z.v[w] = bit ? s.z.v[w] : acc.z.v[w];
      }
    }
  }
  ed_store<A>(ox, oy, ot, oz, n, c, acc);
}

// E2: pointwise p + q, or p - q when `neg` (eneg: X and T negated).
template <class Cv>
__global__ void __launch_bounds__(kEdThreads, 1)
    ed_map_add_kernel(const u32* __restrict__ x1, const u32* __restrict__ y1,
                      const u32* __restrict__ t1, const u32* __restrict__ z1,
                      const u32* __restrict__ x2, const u32* __restrict__ y2,
                      const u32* __restrict__ t2, const u32* __restrict__ z2,
                      u32* __restrict__ ox, u32* __restrict__ oy, u32* __restrict__ ot,
                      u32* __restrict__ oz, int n, int neg) {
  typedef typename Cv::A A;
  const int c = blockIdx.x * kEdThreads + threadIdx.x;
  if (c >= n) return;
  const Ext<A> p = ed_load<A>(x1, y1, t1, z1, n, c);
  Ext<A> q = ed_load<A>(x2, y2, t2, z2, n, c);
  if (neg) {
    q.x = A::sub(A::zero(), q.x);
    q.t = A::sub(A::zero(), q.t);
  }
  ed_store<A>(ox, oy, ot, oz, n, c, eadd<Cv>(p, q));
}

// E3: `times` doublings in a row, fused.
template <class Cv>
__global__ void __launch_bounds__(kEdThreads, 1)
    ed_map_double_kernel(const u32* __restrict__ x, const u32* __restrict__ y,
                         const u32* __restrict__ t, const u32* __restrict__ z,
                         u32* __restrict__ ox, u32* __restrict__ oy, u32* __restrict__ ot,
                         u32* __restrict__ oz, int n, int times) {
  typedef typename Cv::A A;
  const int c = blockIdx.x * kEdThreads + threadIdx.x;
  if (c >= n) return;
  Ext<A> p = ed_load<A>(x, y, t, z, n, c);
#pragma unroll 1
  for (int i = 0; i < times; i++) p = edouble<Cv>(p);
  ed_store<A>(ox, oy, ot, oz, n, c, p);
}

inline int ed_blocks(int n) { return (n + kEdThreads - 1) / kEdThreads; }

}  // namespace kt

using namespace kt;

#define KT_ED_ENTRIES(NAME, CV)                                                               \
  extern "C" int kt_ed_scalar_mul_##NAME(const void* px, const void* py, const void* pt,      \
                                         const void* pz, int pn, const void* k, void* ox,     \
                                         void* oy, void* ot, void* oz, int n, void* stream) { \
    ed_scalar_mul_kernel<CV><<<ed_blocks(n), kEdThreads, 0, (cudaStream_t)stream>>>(           \
        (const u32*)px, (const u32*)py, (const u32*)pt, (const u32*)pz, pn, (const u32*)k,    \
        (u32*)ox, (u32*)oy, (u32*)ot, (u32*)oz, n);                                           \
    return (int)cudaGetLastError();                                                           \
  }                                                                                           \
  extern "C" int kt_ed_map_add_##NAME(const void* x1, const void* y1, const void* t1,         \
                                      const void* z1, const void* x2, const void* y2,         \
                                      const void* t2, const void* z2, void* ox, void* oy,     \
                                      void* ot, void* oz, int n, int neg, void* stream) {     \
    ed_map_add_kernel<CV><<<ed_blocks(n), kEdThreads, 0, (cudaStream_t)stream>>>(              \
        (const u32*)x1, (const u32*)y1, (const u32*)t1, (const u32*)z1, (const u32*)x2,       \
        (const u32*)y2, (const u32*)t2, (const u32*)z2, (u32*)ox, (u32*)oy, (u32*)ot,         \
        (u32*)oz, n, neg);                                                                    \
    return (int)cudaGetLastError();                                                           \
  }                                                                                           \
  extern "C" int kt_ed_map_double_##NAME(const void* x, const void* y, const void* t,         \
                                         const void* z, void* ox, void* oy, void* ot,         \
                                         void* oz, int n, int times, void* stream) {          \
    ed_map_double_kernel<CV><<<ed_blocks(n), kEdThreads, 0, (cudaStream_t)stream>>>(           \
        (const u32*)x, (const u32*)y, (const u32*)t, (const u32*)z, (u32*)ox, (u32*)oy,       \
        (u32*)ot, (u32*)oz, n, times);                                                        \
    return (int)cudaGetLastError();                                                           \
  }

KT_ED_ENTRIES(jubjub, Jubjub)
