// Issue-rate probe for the two instructions field.cuh's Montgomery multiply
// is made of. ops/ec.py `bound_ms` counts a multiply as 264 32-bit integer
// multiply-adds at NVIDIA's published 64 per SM per clock; this measures what
// the card issues of each form. Not on the prove path.
//
//   mode 0: 32-bit multiply-add `a = a * x + y` (SASS IMAD, one multiply-add):
//           the 8 digits m_i = X[0] * (-p^-1) of a multiply.
//   mode 1: field.cuh's `odd_row`, a carry chain of 8 mad.lo.cc/madc.hi.cc,
//           which ptxas fuses into 4 IMAD.WIDE(.X), each one lo/hi pair (two
//           multiply-adds): the 128 pairs of a multiply, issued as the
//           multiply issues them. chip_smoke.py's build phase prints both
//           kernels' SASS counts.
//
// Each thread runs `iters` rounds of kChains independent chains of 8 words,
// enough independent work to hide latency, and records its clock64() cycles.
// The launch is one full wave, the occupancy's blocks per SM on every SM, so
// each SM runs blocks_per_sm * kProbeThreads threads throughout and
//   instructions per SM per clock = blocks_per_sm * kProbeThreads * iters
//                                   * per_round / (the longest thread's cycles),
// which, with the longest thread, can only understate the rate.
//
// Latency, for the critical-path floor of the one-lane shapes (chip_smoke.py):
// `mul_latency_kernel` is one thread running a chain of dependent Montgomery
// multiplies over Fq, a = a * b, inline (fp_mul, as G1's kernels run it) or
// through fp_mul_call (as G2's do), timed with clock64(); `empty_kernel`
// does nothing, for the time of a launch. `spin_kernel` holds its stream for
// a number of clock cycles, so that the host can queue the launches a timing
// measures behind it and the device time between two events is not the
// host's launch overhead (ops/ec.py `device_ms`).

#include <cuda_runtime.h>

#include "field.cuh"

namespace kt {

constexpr int kProbeThreads = 256;
constexpr int kChains = 4;

__global__ void __launch_bounds__(kProbeThreads)
    imad_probe_kernel(u32* __restrict__ sink, long long* __restrict__ cycles, int iters) {
  const u32 gid = blockIdx.x * kProbeThreads + threadIdx.x;
  u32 acc[kChains][8], x[8];
#pragma unroll
  for (int k = 0; k < 8; k++) {
    x[k] = gid * 0x9e3779b9u + 2 * k + 1;
#pragma unroll
    for (int c = 0; c < kChains; c++) acc[c][k] = gid ^ (c * 8 + k);
  }
  const long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < iters; i++) {
#pragma unroll
    for (int c = 0; c < kChains; c++)
#pragma unroll
      for (int k = 0; k < 8; k++) acc[c][k] = acc[c][k] * x[k] + x[(k + 1) & 7];
  }
  const long long t1 = clock64();
  u32 s = 0;
#pragma unroll
  for (int c = 0; c < kChains; c++)
#pragma unroll
    for (int k = 0; k < 8; k++) s ^= acc[c][k];
  sink[gid] = s;
  cycles[gid] = t1 - t0;
}

__global__ void __launch_bounds__(kProbeThreads)
    imad_wide_probe_kernel(u32* __restrict__ sink, long long* __restrict__ cycles, int iters) {
  const u32 gid = blockIdx.x * kProbeThreads + threadIdx.x;
  u32 acc[kChains][8], x[8];
#pragma unroll
  for (int k = 0; k < 8; k++) {
    x[k] = gid * 0x9e3779b9u + 2 * k + 1;
#pragma unroll
    for (int c = 0; c < kChains; c++) acc[c][k] = gid ^ (c * 8 + k);
  }
  const long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < iters; i++) {
#pragma unroll
    for (int c = 0; c < kChains; c++)
      odd_row(acc[c], x[1], x[3], x[5], x[7], acc[(c + 1) % kChains][0]);
  }
  const long long t1 = clock64();
  u32 s = 0;
#pragma unroll
  for (int c = 0; c < kChains; c++)
#pragma unroll
    for (int k = 0; k < 8; k++) s ^= acc[c][k];
  sink[gid] = s;
  cycles[gid] = t1 - t0;
}

template <bool kCall>
__global__ void mul_latency_kernel(u32* __restrict__ sink, long long* __restrict__ cycles,
                                   int iters) {
  Elem<8> a, b;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    a.v[k] = 0x1234567u * (k + 1);
    b.v[k] = 0x89abcdeu * (k + 3);
  }
  a.v[7] &= 0x0fffffffu;  // below q
  b.v[7] &= 0x0fffffffu;
  const long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < iters; i++) {
    if (kCall) {
      a = fp_mul_call<Fq>(a, b);
    } else {
      Elem<8> r;
      fp_mul<Fq>(r.v, a.v, b.v);
      a = r;
    }
  }
  const long long t1 = clock64();
  u32 s = 0;
#pragma unroll
  for (int k = 0; k < 8; k++) s ^= a.v[k];
  sink[0] = s;
  cycles[0] = t1 - t0;
}

__global__ void empty_kernel() {}

__global__ void spin_kernel(long long cycles) {
  const long long t0 = clock64();
  while (clock64() - t0 < cycles) {
  }
}

}  // namespace kt

using namespace kt;

// info: [blocks per SM, threads per block, instructions per thread per round].
extern "C" int kt_imad_probe_info(int mode, int* info) {
  info[0] = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &info[0], mode == 0 ? imad_probe_kernel : imad_wide_probe_kernel, kProbeThreads, 0);
  info[1] = kProbeThreads;
  info[2] = kChains * (mode == 0 ? 8 : 4);
  return (int)cudaGetLastError();
}

// sink: (blocks * kProbeThreads) u32, cycles: (blocks * kProbeThreads) int64.
extern "C" int kt_imad_probe(int mode, int iters, int blocks, void* sink, void* cycles,
                             void* stream) {
  auto kernel = mode == 0 ? imad_probe_kernel : imad_wide_probe_kernel;
  kernel<<<blocks, kProbeThreads, 0, (cudaStream_t)stream>>>((u32*)sink, (long long*)cycles,
                                                             iters);
  return (int)cudaGetLastError();
}

// sink: 1 u32, cycles: 1 int64; call 0: inline fp_mul, 1: fp_mul_call.
extern "C" int kt_mul_latency(int call, int iters, void* sink, void* cycles, void* stream) {
  auto kernel = call ? mul_latency_kernel<true> : mul_latency_kernel<false>;
  kernel<<<1, 1, 0, (cudaStream_t)stream>>>((u32*)sink, (long long*)cycles, iters);
  return (int)cudaGetLastError();
}

extern "C" int kt_empty(void* stream) {
  empty_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

extern "C" int kt_spin(long long cycles, void* stream) {
  spin_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(cycles);
  return (int)cudaGetLastError();
}
