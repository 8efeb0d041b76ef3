// Shared pieces of the hand-written dequant-matmul kernels.
//
// Both kernels use the same block shape: 32 threads along N (one warp reads
// consecutive columns of a weight row, so its loads coalesce) times 8 warps
// along M. Each thread owns CPT adjacent columns and RPT rows of M, strided
// by 8 so that a warp's reads of the staged activations all hit the same
// shared-memory word (a broadcast). Activations are staged through shared
// memory in float32, RC rows of K at a time.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace oqt {

constexpr int kThreadsN = 32;  // threads along N
constexpr int kThreadsM = 8;   // threads along M
constexpr int kThreads = kThreadsN * kThreadsM;
constexpr int kRowChunk = 32;  // K rows staged per step

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// CPT adjacent bytes of one weight row (a single 32-bit load when CPT == 4;
// the wrapper guarantees N % 4 == 0 and a 4-byte aligned base then).
template <int CPT>
__device__ __forceinline__ uint32_t load_bytes(const uint8_t* p) {
  if constexpr (CPT == 4) {
    return *reinterpret_cast<const uint32_t*>(p);
  } else {
    return static_cast<uint32_t>(*p);
  }
}

// Stage x[m0 : m0+BM, k0 : k0+rc] into dst[BM][kRowChunk] as float32, zero
// outside the matrix (rows past M) and past rc.
template <typename T, int BM>
__device__ __forceinline__ void stage_rows(float (*dst)[kRowChunk], const T* __restrict__ x,
                                           int M, int ld, int m0, int k0, int rc, int tid) {
  for (int i = tid; i < BM * kRowChunk; i += kThreads) {
    const int m = i / kRowChunk;
    const int r = i % kRowChunk;
    float v = 0.f;
    if (m0 + m < M && r < rc) v = to_f32(x[static_cast<size_t>(m0 + m) * ld + k0 + r]);
    dst[m][r] = v;
  }
}

}  // namespace oqt
