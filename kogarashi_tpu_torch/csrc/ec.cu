// Batched short-Weierstrass point kernels (BN254 G1 over Fq, G2 over Fq2,
// Grumpkin over Fr).
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
// maps take (W, C). W = 8 for G1 and Grumpkin, 16 for G2. Thread c touches
// word k of lane c at k*plane + c, so each of a warp's loads and stores
// covers 32 neighbouring words (128 bytes): every coordinate access is
// coalesced.
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
// multiply by 9R it replaces. Grumpkin has b = -17, so b3 = -51, seven adds
// and a negation (`Grumpkin::mul_b3`). G2's b3 is a general Fq2 constant.
//
// Grumpkin (Nova's secondary commitments, ops/msm.py at 78982 points) runs
// G1's templates with the base field Fr: the same 8-word multiply (field.cuh
// states its bound for r), G1's block settings, 32-bit K2 offsets, shuffle
// exchanges, and K2 / K4 lane groups of the sizes G1 builds.
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
//     projective point and padd (12 / 42 multiplies), no prefetch. G1 takes
//     32-bit word offsets, which keeps 64-bit address arithmetic off the IMAD
//     pipe (0.162 -> 0.136 ms at (8, 8, 65552), PERF.md). 168 / 252
//     registers. The MSM launches it 20 times at 13 shapes
//     (ops/msm.py `scan_proj_launches`): at C >= 32768 (G1) or 16384 (G2) it
//     fills the card and is bound by multiply-adds (0.64-0.73 of the bound);
//     below, one thread per lane leaves SMs idle and the launch is bound by
//     its chain of L dependent padds, so a lane runs on a lane group (below)
//     of g = 2-8 (G1) or 8-16 (G2) threads. At the smallest shapes a launch
//     then takes about 6.3 us (G1): the launch, two dependent loads of the
//     chunk's points and 4 levels of multiplies.
//   K3 map_padd (replaces `_map_call("padd")`): one thread per lane, six
//     coordinate loads, padd (12 / 42 multiplies), three stores. 128 / 248
//     registers, 4 / 2 blocks per SM; (rows, 2^20) is 8192 blocks, 15.5 / 31
//     waves. SASS (G1): 3056 instructions.
//   K4 map_pdouble (replaces `_map_call("pdouble:t")`): `times` doublings per
//     thread (8 / 25 multiplies each), 108 / 198 registers, at wide C. The
//     MSM's window combine runs it at one lane, bound by one dependency chain:
//     there it runs on a lane group of 4 (G1) or 16 (G2) threads, which
//     shortens a doubling from 8 / 25 multiplies in a row to 2 / 3 levels of
//     them. 64 / 141 registers. A level then takes about 3.4x (G1) / 4.7x
//     (G2) one multiply's dependent latency (csrc/imad_probe.cu): the adds
//     between levels and the exchange take the rest.
//
// Lane groups (K2, K4; the level and exchange are csrc/lane_group.cuh's,
// shared with csrc/edwards.cu): one lane's point op on g threads of one warp,
// one dependency level at a time. The level's independent base-field products
// (an Fq2 multiply is three, a square two) are dealt out over the group; the
// adds between levels run redundantly on each thread. G1 exchanges the
// products by __shfl_sync (at most 6 a level), G2 through shared memory (up
// to 18, two 16-byte loads each instead of 8 shuffles), as measured faster.
// No thread returns before an exchange: a warp returns only when all its
// lanes lie past C, and threads past C compute on lane C - 1 and store
// nothing. A group never straddles a warp (g divides 32). ops/ec.py
// `lane_group` picks g from measured thresholds; g = 1 is the one-thread
// kernel. G2 at g = 2 and 4 spilled (136-276 bytes), so is not built.

#include <cuda_runtime.h>

#include "field.cuh"
#include "lane_group.cuh"

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
  static constexpr bool kB3ByAdds = true;
  // K2's word offsets: 32-bit (rows * L * C < 2^32, ops/ec.py checks), which
  // keeps 64-bit address arithmetic off the IMAD pipe the multiply is bound by
  typedef u32 ScanIndex;
  // lane groups: products exchanged by shuffles (at most 6 a level); K4's
  // group at one lane, one round a level
  static constexpr bool kShuffle = true;
  static constexpr int kPdoubleGroup = 4;
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
  static constexpr bool kB3ByAdds = false;
  // K2's word offsets: 64-bit (with 32-bit ones ptxas spills the one-thread K2)
  typedef size_t ScanIndex;
  // lane groups: products exchanged through shared memory (up to 18 a level,
  // each two 16-byte loads instead of 8 shuffles); K4's group at one lane
  static constexpr bool kShuffle = false;
  static constexpr int kPdoubleGroup = 16;
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

// Grumpkin, y^2 = x^3 - 17 over Fr: the commitment curve of Nova's secondary
// circuit. Its kernels are G1's with the base field Fr and its own b3.
struct Grumpkin {
  typedef Alg1<Fr> A;
  static constexpr int W = 8;
  static constexpr int kMinBlocks = 4;
  static constexpr int kScanMinBlocks = 1;
  static constexpr bool kB3ByAdds = true;
  typedef u32 ScanIndex;
  static constexpr bool kShuffle = true;
  static constexpr int kPdoubleGroup = 4;
  // b3 = 3 * (-17) = -51: 17x = 16x + x, 51x = 2 (17x) + 17x, then negated;
  // seven modular adds and a negation in place of one multiply
  __device__ __forceinline__ static A::E mul_b3(const A::E& x) {
    A::E x16 = A::add(x, x);
    x16 = A::add(x16, x16);
    x16 = A::add(x16, x16);
    x16 = A::add(x16, x16);
    const A::E x17 = A::add(x16, x);
    return A::sub(A::zero(), A::add(A::add(x17, x17), x17));
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
  typedef typename Cv::ScanIndex I;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const I plane = (I)L * C;
  Proj<A> acc = identity<Cv>();
  for (int j = 0; j < L; j++) {
    const I off = (I)j * C + c;
    Proj<A> q;
    q.x = A::template load<I>(x, plane, off);
    q.y = A::template load<I>(y, plane, off);
    q.z = A::template load<I>(z, plane, off);
    acc = padd<Cv>(acc, q);
    A::template store<I>(ox, plane, off, acc.x);
    A::template store<I>(oy, plane, off, acc.y);
    A::template store<I>(oz, plane, off, acc.z);
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

// ---------------------------------------------------------------------------
// Lane groups (lane_group.cuh): K2 and K4 where one thread per lane leaves
// the card idle.
// ---------------------------------------------------------------------------

// RCB16 Alg 7 on a group: G1 in 2 levels of 6 multiplies (its b3 products
// are adds), G2 in 3 of 18, 6 and 18 base multiplies.
template <class Cv, int G, bool S>
__device__ __forceinline__ Proj<typename Cv::A> padd_group(const Proj<typename Cv::A>& p,
                                                           const Proj<typename Cv::A>& q,
                                                           const Group<G, S>& grp) {
  typedef typename Cv::A A;
  typedef typename A::E E;
  typedef Parts<A> P;
  constexpr int M = P::kMul;
  Elem<8> a1[6 * M], b1[6 * M], m1[6 * M];
  P::mul_in(a1, b1, p.x, q.x);
  P::mul_in(a1 + M, b1 + M, p.y, q.y);
  P::mul_in(a1 + 2 * M, b1 + 2 * M, p.z, q.z);
  P::mul_in(a1 + 3 * M, b1 + 3 * M, A::add(p.x, p.y), A::add(q.x, q.y));
  P::mul_in(a1 + 4 * M, b1 + 4 * M, A::add(p.y, p.z), A::add(q.y, q.z));
  P::mul_in(a1 + 5 * M, b1 + 5 * M, A::add(p.x, p.z), A::add(q.x, q.z));
  level<A, G, S>(m1, a1, b1, grp);
  E t0 = P::mul_out(m1), t1 = P::mul_out(m1 + M), t2 = P::mul_out(m1 + 2 * M);
  E t3 = A::sub(A::sub(P::mul_out(m1 + 3 * M), t0), t1);
  E t4 = A::sub(A::sub(P::mul_out(m1 + 4 * M), t1), t2);
  E t5 = A::sub(A::sub(P::mul_out(m1 + 5 * M), t0), t2);
  E t6 = A::add(A::add(t0, t0), t0);
  E t2b3, y5;
  if constexpr (Cv::kB3ByAdds) {
    t2b3 = Cv::mul_b3(t2);
    y5 = Cv::mul_b3(t5);
  } else {
    Elem<8> a2[2 * M], b2[2 * M], m2[2 * M];
    P::mul_in(a2, b2, t2, Cv::b3());
    P::mul_in(a2 + M, b2 + M, t5, Cv::b3());
    level<A, G, S>(m2, a2, b2, grp);
    t2b3 = P::mul_out(m2);
    y5 = P::mul_out(m2 + M);
  }
  E zz = A::add(t1, t2b3);
  E tt = A::sub(t1, t2b3);
  Elem<8> a3[6 * M], b3[6 * M], m3[6 * M];
  P::mul_in(a3, b3, t3, tt);
  P::mul_in(a3 + M, b3 + M, t4, y5);
  P::mul_in(a3 + 2 * M, b3 + 2 * M, y5, t6);
  P::mul_in(a3 + 3 * M, b3 + 3 * M, tt, zz);
  P::mul_in(a3 + 4 * M, b3 + 4 * M, zz, t4);
  P::mul_in(a3 + 5 * M, b3 + 5 * M, t6, t3);
  level<A, G, S>(m3, a3, b3, grp);
  Proj<A> r;
  r.x = A::sub(P::mul_out(m3), P::mul_out(m3 + M));
  r.y = A::add(P::mul_out(m3 + 2 * M), P::mul_out(m3 + 3 * M));
  r.z = A::add(P::mul_out(m3 + 4 * M), P::mul_out(m3 + 5 * M));
  return r;
}

// RCB16 Alg 9 on a group. G1: y^2, z^2, y z, x y; then b3 z^2 by adds; then
// the four products of t2 = b3 z^2 and t0 = y^2: 2 levels of 4 multiplies.
// G2: the first level's 10 base multiplies; b3 z^2 and (y z) 8y^2 (6); the
// other three products (9): 3 levels.
template <class Cv, int G, bool S>
__device__ __forceinline__ Proj<typename Cv::A> pdouble_group(const Proj<typename Cv::A>& p,
                                                              const Group<G, S>& grp) {
  typedef typename Cv::A A;
  typedef typename A::E E;
  typedef Parts<A> P;
  constexpr int M = P::kMul, Q = P::kSqr;
  constexpr int N1 = 2 * Q + 2 * M;
  Elem<8> a1[N1], b1[N1], m1[N1];
  P::sqr_in(a1, b1, p.y);
  P::sqr_in(a1 + Q, b1 + Q, p.z);
  P::mul_in(a1 + 2 * Q, b1 + 2 * Q, p.y, p.z);
  P::mul_in(a1 + 2 * Q + M, b1 + 2 * Q + M, p.x, p.y);
  level<A, G, S>(m1, a1, b1, grp);
  E t0 = P::sqr_out(m1), zsq = P::sqr_out(m1 + Q);
  E t1 = P::mul_out(m1 + 2 * Q), xy = P::mul_out(m1 + 2 * Q + M);
  E z8 = A::add(t0, t0);
  z8 = A::add(z8, z8);
  z8 = A::add(z8, z8);  // 8 y^2
  Proj<A> r;
  E t2;
  if constexpr (Cv::kB3ByAdds) {
    t2 = Cv::mul_b3(zsq);
  } else {
    Elem<8> a2[2 * M], b2[2 * M], m2[2 * M];
    P::mul_in(a2, b2, zsq, Cv::b3());
    P::mul_in(a2 + M, b2 + M, t1, z8);
    level<A, G, S>(m2, a2, b2, grp);
    t2 = P::mul_out(m2);
    r.z = P::mul_out(m2 + M);
  }
  E y3 = A::add(t0, t2);
  t0 = A::sub(t0, A::add(A::add(t2, t2), t2));
  constexpr int N3 = Cv::kB3ByAdds ? 4 * M : 3 * M;
  Elem<8> a3[N3], b3[N3], m3[N3];
  P::mul_in(a3, b3, t2, z8);
  P::mul_in(a3 + M, b3 + M, t0, y3);
  P::mul_in(a3 + 2 * M, b3 + 2 * M, t0, xy);
  if constexpr (Cv::kB3ByAdds) P::mul_in(a3 + 3 * M, b3 + 3 * M, t1, z8);
  level<A, G, S>(m3, a3, b3, grp);
  if constexpr (Cv::kB3ByAdds) r.z = P::mul_out(m3 + 3 * M);
  r.y = A::add(P::mul_out(m3 + M), P::mul_out(m3));
  E xf = P::mul_out(m3 + 2 * M);
  r.x = A::add(xf, xf);
  return r;
}

// Products a level exchanges at most: K2's padd 6 algebra multiplies, K4's
// doubling two squares and two multiplies.
template <class Cv>
struct MaxProducts {
  typedef Parts<typename Cv::A> P;
  static constexpr int kPadd = 6 * P::kMul, kPdouble = 2 * P::kSqr + 2 * P::kMul;
};

// K2 on lane groups.
template <class Cv, int G>
__global__ void __launch_bounds__(kThreads, Cv::kScanMinBlocks)
    scan_proj_group_kernel(const u32* __restrict__ x, const u32* __restrict__ y,
                           const u32* __restrict__ z, u32* __restrict__ ox,
                           u32* __restrict__ oy, u32* __restrict__ oz, int L, int C) {
  typedef typename Cv::A A;
  typedef Parts<A> P;
  constexpr bool S = Cv::kShuffle;  // no exchange buffer then
  __shared__ uint4 ex[kThreads / 32][S ? 1 : MaxProducts<Cv>::kPadd * Group<G, S>::kStride];
  const GroupLane<G, S, kThreads> g(C, ex[threadIdx.x / 32]);
  if (g.warp_idle) return;
  typedef typename Cv::ScanIndex I;
  const I plane = (I)L * C;
  Proj<A> acc = identity<Cv>();
  for (int j = 0; j < L; j++) {
    const I off = (I)j * C + g.c;
    Proj<A> q;
    q.x = A::template load<I>(x, plane, off);
    q.y = A::template load<I>(y, plane, off);
    q.z = A::template load<I>(z, plane, off);
    acc = padd_group<Cv, G, S>(acc, q, g.grp);
    if (g.lane < C) {
      P::template store<G>(ox, plane, off, acc.x, g.grp.rank);
      P::template store<G>(oy, plane, off, acc.y, g.grp.rank);
      P::template store<G>(oz, plane, off, acc.z, g.grp.rank);
    }
  }
}

// K4 on lane groups.
template <class Cv, int G>
__global__ void __launch_bounds__(kThreads, 1)
    pdouble_group_kernel(const u32* __restrict__ x, const u32* __restrict__ y,
                         const u32* __restrict__ z, u32* __restrict__ ox, u32* __restrict__ oy,
                         u32* __restrict__ oz, int C, int times) {
  typedef typename Cv::A A;
  typedef Parts<A> P;
  constexpr bool S = Cv::kShuffle;  // no exchange buffer then
  __shared__ uint4 ex[kThreads / 32][S ? 1 : MaxProducts<Cv>::kPdouble * Group<G, S>::kStride];
  const GroupLane<G, S, kThreads> g(C, ex[threadIdx.x / 32]);
  if (g.warp_idle) return;
  Proj<A> p;
  p.x = A::load(x, C, g.c);
  p.y = A::load(y, C, g.c);
  p.z = A::load(z, C, g.c);
  for (int t = 0; t < times; t++) p = pdouble_group<Cv, G, S>(p, g.grp);
  if (g.lane < C) {
    P::template store<G>(ox, C, g.c, p.x, g.grp.rank);
    P::template store<G>(oy, C, g.c, p.y, g.grp.rank);
    P::template store<G>(oz, C, g.c, p.z, g.grp.rank);
  }
}

inline int blocks(int C) { return (C + kThreads - 1) / kThreads; }

typedef void (*ScanProjKernel)(const u32*, const u32*, const u32*, u32*, u32*, u32*, int, int);
typedef void (*PdoubleKernel)(const u32*, const u32*, const u32*, u32*, u32*, u32*, int, int);

// K2 and K4 at group size g (1: the one-thread kernels): the sizes some
// shape of the main path picks (ops/ec.py LANE_GROUPS), and no other;
// nullptr for any other g.
template <class Cv>
ScanProjKernel scan_proj_at(int g) {
  if (g == 1) return scan_proj_kernel<Cv>;
  if constexpr (Cv::W == 8) {
    if (g == 2) return scan_proj_group_kernel<Cv, 2>;
    if (g == 4) return scan_proj_group_kernel<Cv, 4>;
    if (g == 8) return scan_proj_group_kernel<Cv, 8>;
  } else {
    if (g == 8) return scan_proj_group_kernel<Cv, 8>;
    if (g == 16) return scan_proj_group_kernel<Cv, 16>;
  }
  return nullptr;
}

template <class Cv>
PdoubleKernel pdouble_at(int g) {
  if (g == 1) return pdouble_kernel<Cv>;
  if (g == Cv::kPdoubleGroup) return pdouble_group_kernel<Cv, Cv::kPdoubleGroup>;
  return nullptr;
}

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
                                     void* ox, void* oy, void* oz, int L, int C, int g, \
                                     void* stream) {                                    \
    const ScanProjKernel k = scan_proj_at<CV>(g);                                       \
    if (!k) return (int)cudaErrorInvalidValue;                                          \
    k<<<blocks(C * g), kThreads, 0, (cudaStream_t)stream>>>(                  \
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
                                       int g, void* stream) {                           \
    const PdoubleKernel k = pdouble_at<CV>(g);                                          \
    if (!k) return (int)cudaErrorInvalidValue;                                          \
    k<<<blocks(C * g), kThreads, 0, (cudaStream_t)stream>>>(                    \
        (const u32*)x, (const u32*)y, (const u32*)z, (u32*)ox, (u32*)oy, (u32*)oz, C,   \
        times);                                                                         \
    return (int)cudaGetLastError();                                                     \
  }

KT_EC_ENTRIES(g1, G1)
KT_EC_ENTRIES(g2, G2)
KT_EC_ENTRIES(grumpkin, Grumpkin)
