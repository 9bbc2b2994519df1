// Elementwise launch of the field.cuh engine, for checking it against the
// plain version (kogarashi_tpu_torch/fields/mont.py) on the card.
//
// Takes the role of the TPU repo's on-chip limb-engine probes
// (scratch/check_pallas.py `mm`/`modadd`/`modsub`, scratch/min_pallas.py).
// It is not on the prove path. Layout: (8, n) int32 word planes; one thread
// per element.

#include <cuda_runtime.h>

#include "field.cuh"

namespace kt {

template <class F>
__global__ void field_op_kernel(const u32* __restrict__ a, const u32* __restrict__ b,
                                u32* __restrict__ out, int op, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  u32 x[8], y[8], r[8];
#pragma unroll
  for (int k = 0; k < 8; k++) {
    x[k] = a[(size_t)k * n + i];
    y[k] = b[(size_t)k * n + i];
  }
  switch (op) {
    case 0: fp_mul<F>(r, x, y); break;
    case 1: fp_mul<F>(r, x, x); break;
    case 2: fp_add<F>(r, x, y); break;
    case 3: fp_sub<F>(r, x, y); break;
    default: fp_neg<F>(r, x); break;
  }
#pragma unroll
  for (int k = 0; k < 8; k++) out[(size_t)k * n + i] = r[k];
}

}  // namespace kt

using namespace kt;

// op: 0 mul, 1 sqr, 2 add, 3 sub, 4 neg.
#define KT_FIELD_ENTRY(NAME, F)                                                          \
  extern "C" int kt_field_op_##NAME(const void* a, const void* b, void* out, int op,     \
                                    int n, void* stream) {                               \
    field_op_kernel<F><<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(               \
        (const u32*)a, (const u32*)b, (u32*)out, op, n);                                 \
    return (int)cudaGetLastError();                                                      \
  }

KT_FIELD_ENTRY(fq, Fq)
KT_FIELD_ENTRY(fr, Fr)
KT_FIELD_ENTRY(blsfr, BlsFr)
