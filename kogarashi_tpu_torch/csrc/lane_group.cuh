// Lane groups: one lane's point op on G threads of one warp (G divides 32),
// one dependency level of multiplies at a time. The level's independent
// base-field products are dealt out over the group (thread `rank` takes
// products rank, rank + G, ...), and every thread of the group receives all of
// them, by `__shfl_sync` (8-word algebras: G1, Grumpkin, Jubjub) or through
// shared memory (G2), before the next level. The adds between levels run
// redundantly on every thread. Every field op is canonical (field.cuh), so the
// result is the one-thread kernel's, word for word.
//
// Used by csrc/ec.cu (K2 scan_proj, K4 map_pdouble) and csrc/edwards.cu (E1
// ed_scalar_mul, E2 ed_map_add, E3 ed_map_double). No thread may return before an exchange: a
// warp returns only when all its lanes lie past the batch, and threads past it
// compute on the last lane and store nothing (`GroupLane`).

#pragma once

#include "field.cuh"

namespace kt {

// An algebra multiply as base-field products. Alg1: one. Alg2: Karatsuba's
// three, or two for a square, in Alg2::mul's and Alg2::sqr's formulas.
template <class A>
struct Parts;

template <class F>
struct Parts<Alg1<F>> {
  typedef Elem<8> E;
  static constexpr int kMul = 1, kSqr = 1;
  __device__ __forceinline__ static Elem<8> bmul(const Elem<8>& a, const Elem<8>& b) {
    Elem<8> r;
    fp_mul<F>(r.v, a.v, b.v);
    return r;
  }
  __device__ __forceinline__ static void mul_in(Elem<8>* a, Elem<8>* b, const E& x, const E& y) {
    a[0] = x;
    b[0] = y;
  }
  __device__ __forceinline__ static void sqr_in(Elem<8>* a, Elem<8>* b, const E& x) {
    mul_in(a, b, x, x);
  }
  __device__ __forceinline__ static E mul_out(const Elem<8>* m) { return m[0]; }
  __device__ __forceinline__ static E sqr_out(const Elem<8>* m) { return m[0]; }
  // words k with k % G == rank of e, to word planes a[k * plane + off]
  template <int G, class I>
  __device__ __forceinline__ static void store(u32* __restrict__ a, I plane, I off, const E& e,
                                               int rank) {
#pragma unroll
    for (int k = 0; k < 8; k++)
      if (k % G == rank) a[k * plane + off] = e.v[k];
  }
};

template <class F>
struct Parts<Alg2<F>> {
  typedef Alg1<F> B;
  typedef typename Alg2<F>::E E;
  static constexpr int kMul = 3, kSqr = 2;
  __device__ __forceinline__ static Elem<8> bmul(const Elem<8>& a, const Elem<8>& b) {
    return fp_mul_call<F>(a, b);
  }
  __device__ __forceinline__ static void mul_in(Elem<8>* a, Elem<8>* b, const E& x, const E& y) {
    a[0] = x.c0;
    b[0] = y.c0;
    a[1] = x.c1;
    b[1] = y.c1;
    a[2] = B::add(x.c0, x.c1);
    b[2] = B::add(y.c0, y.c1);
  }
  __device__ __forceinline__ static void sqr_in(Elem<8>* a, Elem<8>* b, const E& x) {
    a[0] = x.c0;
    b[0] = x.c1;
    a[1] = B::add(x.c0, x.c1);
    b[1] = B::sub(x.c0, x.c1);
  }
  __device__ __forceinline__ static E mul_out(const Elem<8>* m) {
    E r;
    r.c0 = B::sub(m[0], m[1]);
    r.c1 = B::sub(B::sub(m[2], m[0]), m[1]);
    return r;
  }
  __device__ __forceinline__ static E sqr_out(const Elem<8>* m) {
    E r;
    r.c0 = m[1];
    r.c1 = B::add(m[0], m[0]);
    return r;
  }
  template <int G, class I>
  __device__ __forceinline__ static void store(u32* __restrict__ a, I plane, I off, const E& e,
                                               int rank) {
#pragma unroll
    for (int k = 0; k < 8; k++) {
      if (k % G == rank) a[k * plane + off] = e.c0.v[k];
      if ((k + 8) % G == rank) a[(k + 8) * plane + off] = e.c1.v[k];
    }
  }
};

// A thread's place in its lane's group: its rank, and the group's slots in
// its warp's exchange buffer in shared memory, laid out [product][group of
// the warp][2 x uint4], so product k of the group is ex[k * kStride], two
// 16-byte words. S: exchange by __shfl_sync instead (no buffer).
template <int G, bool S>
struct Group {
  static constexpr int kStride = 2 * (32 / G);
  int rank;
  uint4* ex;
};

// One level: products m[k] = a[k] * b[k], k < N, on a group of G threads.
// Thread `rank` selects its operands (word by word, no divergence) and makes
// one multiply per round; each product goes to the exchange buffer as it is
// made, and every thread of the group reads all N back.
template <class A, int G, bool S, int N>
__device__ __forceinline__ void level(Elem<8> (&m)[N], const Elem<8> (&a)[N],
                                      const Elem<8> (&b)[N], const Group<G, S>& g) {
  constexpr int R = (N + G - 1) / G;
  auto mul = [&](int r) {
    Elem<8> x = a[r * G], y = b[r * G];
#pragma unroll
    for (int j = 1; j < G; j++) {
      const int k = r * G + j;
      if (k < N) {
        const bool take = g.rank == j;
#pragma unroll
        for (int w = 0; w < 8; w++) {
          x.v[w] = take ? a[k].v[w] : x.v[w];
          y.v[w] = take ? b[k].v[w] : y.v[w];
        }
      }
    }
    return Parts<A>::bmul(x, y);
  };
  if constexpr (S) {
    Elem<8> mine[R];
#pragma unroll
    for (int r = 0; r < R; r++) mine[r] = mul(r);
#pragma unroll
    for (int k = 0; k < N; k++)
#pragma unroll
      for (int w = 0; w < 8; w++)
        m[k].v[w] = __shfl_sync(0xffffffffu, mine[k / G].v[w], k % G, G);
  } else {
    __syncwarp();  // the group has read the previous level's products
#pragma unroll
    for (int r = 0; r < R; r++) {
      const Elem<8> mine = mul(r);
      const int k = r * G + g.rank;
      if (k < N) {
        uint4* s = g.ex + k * Group<G, S>::kStride;
        s[0] = make_uint4(mine.v[0], mine.v[1], mine.v[2], mine.v[3]);
        s[1] = make_uint4(mine.v[4], mine.v[5], mine.v[6], mine.v[7]);
      }
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < N; k++) {
      const uint4 lo = g.ex[k * Group<G, S>::kStride], hi = g.ex[k * Group<G, S>::kStride + 1];
      m[k] = Elem<8>{{lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w}};
    }
  }
}

// The lane of thread t of a launch in blocks of T threads, and its place in
// the lane's group. A warp whose lanes all lie at or past C returns at once;
// in any other warp every thread stays through the exchanges, those past C on
// lane C - 1's words, and stores nothing. `ex`: the warp's exchange buffer
// (unused when S).
template <int G, bool S, int T>
struct GroupLane {
  int lane, c;
  bool warp_idle;
  Group<G, S> grp;
  __device__ __forceinline__ GroupLane(int C, uint4* ex) {
    const int t = blockIdx.x * T + threadIdx.x;
    lane = t / G;
    c = lane < C ? lane : C - 1;
    warp_idle = (t & ~31) / G >= C;
    grp.rank = t % G;
    grp.ex = S ? nullptr : ex + 2 * ((threadIdx.x % 32) / G);
  }
};

}  // namespace kt
