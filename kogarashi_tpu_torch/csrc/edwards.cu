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
// eadd is 9 multiplies and the multiply by d, edouble 3 squares and 5
// multiplies; the negations of a = -1 are canonical subtracts from 0. Field
// ops are canonical (field.cuh, whose bound argument covers BlsFr, p < 2^255),
// so every output equals the plain version's (ops/edwards.py) bit for bit,
// whatever the association of a product: E1 forms d T_P once and computes
// T (d T_P) where the JAX ladder computes d (T T_P), the same element.
//
// Layout: a point is four int32 word planes (X, Y, T, Z), each (8, n), word
// k of lane c at k * n + c, so each of a warp's loads and stores covers 32
// neighbouring words. Scalars are (16, n) int32 standard-form 16-bit limbs,
// the JAX package's `ints_to_limbs(...).T`; any 256-bit value is taken.
//
// What bounds them (ops/edwards.py `bound_ms`): 32-bit integer multiply-adds,
// 264 per Montgomery multiply (field.cuh), at NVIDIA's 64 per SM per clock on
// 132 SMs. E1 needs 256 x 16 + 2 multiplies a lane (d T_P; a doubling's 8
// and an add's 8 a bit; the last add's T), E2 10, E3 7 a doubling and the
// last doubling's T.
// Where one thread per lane leaves SMs idle, a lane runs on a lane group of g
// threads of one warp (csrc/lane_group.cuh, as K2 and K4 in csrc/ec.cu): one
// dependency level of multiplies at a time, the level's products dealt out
// over the group and exchanged by __shfl_sync. ops/ec.py `lane_group` picks g
// from the lane count, by thresholds measured on an H100 with
// profile_edwards.py (PERF.md): the fewer the lanes, the larger g. Only the g
// it can pick are built (KT_ED_GROUPS); g = 1 is the one-thread kernel. A
// group kernel runs kEdGroupLanes lanes a block, so at the 1024-signature
// path's 2048 lanes E1 spreads over 128 blocks (4 warps each at g = 8); the
// one-thread kernels run kEdThreads lanes a block.
//   E1 ed_scalar_mul: MSB-first double-and-add over all 256 bits as JAX's
//     scan runs it: the add is always computed and the bit selects (SEL, no
//     branch on the data); every thread of a group selects on the words it
//     holds. The base is one broadcast point (pn = 1) or one per lane (pn =
//     n); d T_P and X_P + Y_P are formed once. A bit is 4 levels: the
//     doubling's x^2, y^2, z^2, x y, then its 4 outputs; the add's X X_P,
//     Y Y_P, T (d T_P), Z Z_P, (X + Y)(X_P + Y_P), then its outputs: X, Y,
//     Z, and T only at the last bit, since a doubling reads no T. Each
//     16-bit limb of k is read once, when its bits start. g = 8 below 4096
//     lanes, 4 below 16384, 2 below 32768, then one thread a lane.
//   E2 ed_map_add: loads, the add in 3 levels (the 5 products, the multiply by
//     d, the 4 outputs), stores. g = 8 below 4096 lanes (the signature path's
//     1024), 4 below 8192, 2 below 16384; from there one thread a lane
//     (116 registers, so 4 blocks of 128 fit an SM uncapped).
//   E3 ed_map_double: loads, `times` doublings of 2 levels each (x^2, y^2,
//     z^2, x y; then X, Y, Z, and T only at the last doubling, since no
//     doubling reads T: 7 t + 1 multiplies), stores. g = 4 below 16384
//     lanes (the signature paths' 1024 and 8192), 2 below 32768, then one
//     thread a lane; g = 8 was within 2% of g = 4 at 1024 lanes and slower
//     from 2048 on.
// chip_smoke.py's build phase prints each kernel's registers and spills.

#include <cuda_runtime.h>

#include "field.cuh"
#include "lane_group.cuh"

// The lane groups (threads per lane) built for E1-E3, as a mask: bit g
// set for group size g. The default is the sizes the lane-count rule
// (ops/ec.py LANE_GROUPS) picks, and no other; profile_edwards.py builds
// every candidate (g <= 16) with -D to time them.
#ifndef KT_ED_GROUPS
#define KT_ED_GROUPS 0x116  // g = 1, 2, 4, 8
#endif

namespace kt {

constexpr int kEdThreads = 128;   // one-thread kernels: lanes (threads) per block
constexpr int kEdGroupLanes = 16;  // group kernels: lanes per block, G * 16 threads

template <int G>
struct EdBlock {
  static_assert(G >= 1 && 32 % G == 0, "a lane group lies within a warp");
  static constexpr int kThreads = G == 1 ? kEdThreads : G * kEdGroupLanes;
};

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

// A fixed base for E1's adds: X, Y, d T, Z and X + Y.
template <class A>
struct Base {
  typename A::E x, y, dt, z, s;
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

// One level of N products on the group (lane_group.cuh); g = 1: in this thread.
template <class A, int G, int N>
__device__ __forceinline__ void ed_level(Elem<8> (&m)[N], const Elem<8> (&a)[N],
                                         const Elem<8> (&b)[N], const Group<G, true>& grp) {
  if constexpr (G == 1) {
#pragma unroll
    for (int k = 0; k < N; k++) m[k] = A::mul(a[k], b[k]);
  } else {
    level<A, G, true>(m, a, b, grp);
  }
}

// eadd's last level (edwards.rs:74-95) from its products aa = X1 X2,
// bb = Y1 Y2, cc = d T1 T2, dd = Z1 Z2 and m = (X1 + Y1)(X2 + Y2). WithT:
// also T = e h; without it (E1's bits but the last, whose T no later
// doubling reads) 3 products, and T is left zero.
template <class Cv, int G, bool WithT = true>
__device__ __forceinline__ Ext<typename Cv::A> eadd_out(const typename Cv::A::E (&p)[5],
                                                        const typename Cv::A::E& cc,
                                                        const Group<G, true>& grp) {
  typedef typename Cv::A A;
  typedef typename A::E E;
  const E h = A::add(p[0], p[1]);
  const E e = A::sub(p[4], h);
  const E f = A::sub(p[3], cc);
  const E g = A::add(p[3], cc);
  if constexpr (WithT) {
    const E a2[4] = {e, g, e, f}, b2[4] = {f, h, h, g};
    E m2[4];
    ed_level<A, G>(m2, a2, b2, grp);
    return Ext<A>{m2[0], m2[1], m2[2], m2[3]};
  } else {
    const E a2[3] = {e, g, f}, b2[3] = {f, h, g};
    E m2[3];
    ed_level<A, G>(m2, a2, b2, grp);
    return Ext<A>{m2[0], m2[1], A::zero(), m2[2]};
  }
}

// Extended + extended: 9 multiplies and one by d, in 3 levels.
template <class Cv, int G>
__device__ __forceinline__ Ext<typename Cv::A> eadd(const Ext<typename Cv::A>& p,
                                                    const Ext<typename Cv::A>& q,
                                                    const Group<G, true>& grp) {
  typedef typename Cv::A A;
  typedef typename A::E E;
  const E a1[5] = {p.x, p.y, p.t, p.z, A::add(p.x, p.y)};
  const E b1[5] = {q.x, q.y, q.t, q.z, A::add(q.x, q.y)};
  E m1[5];
  ed_level<A, G>(m1, a1, b1, grp);
  return eadd_out<Cv, G>(m1, A::mul(Cv::d(), m1[2]), grp);
}

// Extended + the fixed base (d T and X + Y formed once): 9 multiplies in 2
// levels, 8 without T.
template <class Cv, int G, bool WithT>
__device__ __forceinline__ Ext<typename Cv::A> eadd_base(const Ext<typename Cv::A>& p,
                                                         const Base<typename Cv::A>& q,
                                                         const Group<G, true>& grp) {
  typedef typename Cv::A A;
  typedef typename A::E E;
  const E a1[5] = {p.x, p.y, p.t, p.z, A::add(p.x, p.y)};
  const E b1[5] = {q.x, q.y, q.dt, q.z, q.s};
  E m1[5];
  ed_level<A, G>(m1, a1, b1, grp);
  return eadd_out<Cv, G, WithT>(m1, m1[2], grp);
}

// Extended doubling, a = -1 (edwards.rs:99-116): 3 squares and 5 multiplies
// in 2 levels. WithT: also T = e dd; without it (E3's doublings but the
// last, whose T the next doubling does not read) 4 multiplies and then 3,
// and T is left zero.
template <class Cv, int G, bool WithT = true>
__device__ __forceinline__ Ext<typename Cv::A> edouble(const Ext<typename Cv::A>& p,
                                                       const Group<G, true>& grp) {
  typedef typename Cv::A A;
  typedef typename A::E E;
  const E a1[4] = {p.x, p.y, p.z, p.x}, b1[4] = {p.x, p.y, p.z, p.y};
  E m1[4];
  ed_level<A, G>(m1, a1, b1, grp);
  const E aa = A::sub(A::zero(), m1[0]);
  const E bb = m1[1];
  const E cc = A::add(m1[2], m1[2]);
  const E dd = A::sub(aa, bb);
  const E e = A::add(m1[3], m1[3]);
  const E g = A::add(aa, bb);
  const E f = A::sub(g, cc);
  if constexpr (WithT) {
    const E a2[4] = {e, g, e, f}, b2[4] = {f, dd, dd, g};
    E m2[4];
    ed_level<A, G>(m2, a2, b2, grp);
    return Ext<A>{m2[0], m2[1], m2[2], m2[3]};
  } else {
    const E a2[3] = {e, g, f}, b2[3] = {f, dd, g};
    E m2[3];
    ed_level<A, G>(m2, a2, b2, grp);
    return Ext<A>{m2[0], m2[1], A::zero(), m2[2]};
  }
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

// The words of p that thread `rank` of a group of G stores (all when G = 1).
template <class A, int G>
__device__ __forceinline__ void ed_store(u32* __restrict__ x, u32* __restrict__ y,
                                         u32* __restrict__ t, u32* __restrict__ z, int plane,
                                         int c, const Ext<A>& p, int rank) {
  Parts<A>::template store<G>(x, plane, c, p.x, rank);
  Parts<A>::template store<G>(y, plane, c, p.y, rank);
  Parts<A>::template store<G>(t, plane, c, p.t, rank);
  Parts<A>::template store<G>(z, plane, c, p.z, rank);
}

// One bit of E1's ladder: acc = [2]acc, plus the base if `bit`, selected
// word by word. WithT: the add's T too (the last bit; the doubling reads none).
template <class Cv, int G, bool WithT>
__device__ __forceinline__ void ladder_bit(Ext<typename Cv::A>& acc,
                                           const Base<typename Cv::A>& base, bool bit,
                                           const Group<G, true>& grp) {
  typedef typename Cv::A A;
  acc = edouble<Cv, G>(acc, grp);
  const Ext<A> s = eadd_base<Cv, G, WithT>(acc, base, grp);
#pragma unroll
  for (int w = 0; w < 8; w++) {
    acc.x.v[w] = bit ? s.x.v[w] : acc.x.v[w];
    acc.y.v[w] = bit ? s.y.v[w] : acc.y.v[w];
    if constexpr (WithT) acc.t.v[w] = bit ? s.t.v[w] : acc.t.v[w];
    acc.z.v[w] = bit ? s.z.v[w] : acc.z.v[w];
  }
}

// E1: [k]P per lane on G threads, MSB first over 256 bits, the add selected
// by the bit.
template <class Cv, int G>
__global__ void __launch_bounds__(EdBlock<G>::kThreads, 1)
    ed_scalar_mul_kernel(const u32* __restrict__ px, const u32* __restrict__ py,
                         const u32* __restrict__ pt, const u32* __restrict__ pz, int pn,
                         const u32* __restrict__ k, u32* __restrict__ ox, u32* __restrict__ oy,
                         u32* __restrict__ ot, u32* __restrict__ oz, int n) {
  typedef typename Cv::A A;
  const GroupLane<G, true, EdBlock<G>::kThreads> g(n, nullptr);
  if (g.warp_idle) return;
  const Ext<A> p = ed_load<A>(px, py, pt, pz, pn, pn == 1 ? 0 : g.c);
  const Base<A> base{p.x, p.y, A::mul(Cv::d(), p.t), p.z, A::add(p.x, p.y)};
  Ext<A> acc = ed_identity<Cv>();
  u32 limb = 0;
#pragma unroll 1
  for (int j = 255; j > 0; j--) {
    if ((j & 15) == 15) limb = k[(size_t)(j >> 4) * n + g.c];
    ladder_bit<Cv, G, false>(acc, base, (limb >> (j & 15)) & 1u, g.grp);
  }
  ladder_bit<Cv, G, true>(acc, base, limb & 1u, g.grp);
  if (g.lane < n) ed_store<A, G>(ox, oy, ot, oz, n, g.c, acc, g.grp.rank);
}

// E2: pointwise p + q, or p - q when `neg` (eneg: X and T negated), on G
// threads a lane.
template <class Cv, int G>
__global__ void __launch_bounds__(EdBlock<G>::kThreads, 1)
    ed_map_add_kernel(const u32* __restrict__ x1, const u32* __restrict__ y1,
                      const u32* __restrict__ t1, const u32* __restrict__ z1,
                      const u32* __restrict__ x2, const u32* __restrict__ y2,
                      const u32* __restrict__ t2, const u32* __restrict__ z2,
                      u32* __restrict__ ox, u32* __restrict__ oy, u32* __restrict__ ot,
                      u32* __restrict__ oz, int n, int neg) {
  typedef typename Cv::A A;
  const GroupLane<G, true, EdBlock<G>::kThreads> g(n, nullptr);
  if (g.warp_idle) return;
  const Ext<A> p = ed_load<A>(x1, y1, t1, z1, n, g.c);
  Ext<A> q = ed_load<A>(x2, y2, t2, z2, n, g.c);
  if (neg) {
    q.x = A::sub(A::zero(), q.x);
    q.t = A::sub(A::zero(), q.t);
  }
  const Ext<A> r = eadd<Cv, G>(p, q, g.grp);
  if (g.lane < n) ed_store<A, G>(ox, oy, ot, oz, n, g.c, r, g.grp.rank);
}

// E3: `times` doublings in a row, fused, on G threads a lane; T made only by
// the last (no doubling reads T).
template <class Cv, int G>
__global__ void __launch_bounds__(EdBlock<G>::kThreads, 1)
    ed_map_double_kernel(const u32* __restrict__ x, const u32* __restrict__ y,
                         const u32* __restrict__ t, const u32* __restrict__ z,
                         u32* __restrict__ ox, u32* __restrict__ oy, u32* __restrict__ ot,
                         u32* __restrict__ oz, int n, int times) {
  typedef typename Cv::A A;
  const GroupLane<G, true, EdBlock<G>::kThreads> g(n, nullptr);
  if (g.warp_idle) return;
  Ext<A> p = ed_load<A>(x, y, t, z, n, g.c);
  if (times > 0) {
#pragma unroll 1
    for (int i = 1; i < times; i++) p = edouble<Cv, G, false>(p, g.grp);
    p = edouble<Cv, G, true>(p, g.grp);
  }
  if (g.lane < n) ed_store<A, G>(ox, oy, ot, oz, n, g.c, p, g.grp.rank);
}

typedef void (*EdMulKernel)(const u32*, const u32*, const u32*, const u32*, int, const u32*, u32*,
                            u32*, u32*, u32*, int);
typedef void (*EdAddKernel)(const u32*, const u32*, const u32*, const u32*, const u32*,
                            const u32*, const u32*, const u32*, u32*, u32*, u32*, u32*, int, int);
typedef void (*EdDoubleKernel)(const u32*, const u32*, const u32*, const u32*, u32*, u32*, u32*,
                               u32*, int, int);

// E1, E2 and E3 at group size g, if built (KT_ED_GROUPS);
// nullptr for any other g.
template <class Cv, int G = 1>
EdMulKernel ed_scalar_mul_at(int g) {
  if constexpr (G > 16) {
    return nullptr;
  } else {
    if constexpr ((KT_ED_GROUPS >> G) & 1)
      if (g == G) return ed_scalar_mul_kernel<Cv, G>;
    return ed_scalar_mul_at<Cv, 2 * G>(g);
  }
}

template <class Cv, int G = 1>
EdAddKernel ed_map_add_at(int g) {
  if constexpr (G > 16) {
    return nullptr;
  } else {
    if constexpr ((KT_ED_GROUPS >> G) & 1)
      if (g == G) return ed_map_add_kernel<Cv, G>;
    return ed_map_add_at<Cv, 2 * G>(g);
  }
}

template <class Cv, int G = 1>
EdDoubleKernel ed_map_double_at(int g) {
  if constexpr (G > 16) {
    return nullptr;
  } else {
    if constexpr ((KT_ED_GROUPS >> G) & 1)
      if (g == G) return ed_map_double_kernel<Cv, G>;
    return ed_map_double_at<Cv, 2 * G>(g);
  }
}

inline int ed_threads(int g) { return g == 1 ? kEdThreads : g * kEdGroupLanes; }

inline int ed_blocks(int n, int g) {
  return (int)(((long long)n * g + ed_threads(g) - 1) / ed_threads(g));
}

}  // namespace kt

using namespace kt;

#define KT_ED_ENTRIES(NAME, CV)                                                               \
  extern "C" int kt_ed_scalar_mul_##NAME(const void* px, const void* py, const void* pt,      \
                                         const void* pz, int pn, const void* k, void* ox,     \
                                         void* oy, void* ot, void* oz, int n, int g,          \
                                         void* stream) {                                      \
    const EdMulKernel kern = ed_scalar_mul_at<CV>(g);                                         \
    if (!kern) return (int)cudaErrorInvalidValue;                                             \
    kern<<<ed_blocks(n, g), ed_threads(g), 0, (cudaStream_t)stream>>>(                        \
        (const u32*)px, (const u32*)py, (const u32*)pt, (const u32*)pz, pn, (const u32*)k,    \
        (u32*)ox, (u32*)oy, (u32*)ot, (u32*)oz, n);                                           \
    return (int)cudaGetLastError();                                                           \
  }                                                                                           \
  extern "C" int kt_ed_map_add_##NAME(const void* x1, const void* y1, const void* t1,         \
                                      const void* z1, const void* x2, const void* y2,         \
                                      const void* t2, const void* z2, void* ox, void* oy,     \
                                      void* ot, void* oz, int n, int neg, int g,              \
                                      void* stream) {                                         \
    const EdAddKernel kern = ed_map_add_at<CV>(g);                                            \
    if (!kern) return (int)cudaErrorInvalidValue;                                             \
    kern<<<ed_blocks(n, g), ed_threads(g), 0, (cudaStream_t)stream>>>(                        \
        (const u32*)x1, (const u32*)y1, (const u32*)t1, (const u32*)z1, (const u32*)x2,       \
        (const u32*)y2, (const u32*)t2, (const u32*)z2, (u32*)ox, (u32*)oy, (u32*)ot,         \
        (u32*)oz, n, neg);                                                                    \
    return (int)cudaGetLastError();                                                           \
  }                                                                                           \
  extern "C" int kt_ed_map_double_##NAME(const void* x, const void* y, const void* t,         \
                                         const void* z, void* ox, void* oy, void* ot,         \
                                         void* oz, int n, int times, int g, void* stream) {   \
    const EdDoubleKernel kern = ed_map_double_at<CV>(g);                                      \
    if (!kern) return (int)cudaErrorInvalidValue;                                             \
    kern<<<ed_blocks(n, g), ed_threads(g), 0, (cudaStream_t)stream>>>(                        \
        (const u32*)x, (const u32*)y, (const u32*)t, (const u32*)z, (u32*)ox, (u32*)oy,       \
        (u32*)ot, (u32*)oz, n, times);                                                        \
    return (int)cudaGetLastError();                                                           \
  }

KT_ED_ENTRIES(jubjub, Jubjub)
