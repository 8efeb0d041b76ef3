// Shared pieces of the hand-written matmul kernels.
//
// The CUDA-core kernels (W8, W4A8, W8A8, and the simt routes of W4 and Q8)
// use one block shape: 32 threads along N (one warp reads consecutive
// columns of a weight row, so its loads coalesce) times 8 warps along M.
// Each thread owns CPT adjacent columns and RPT rows of M, strided by 8 so
// that a warp's reads of the staged activations all hit the same
// shared-memory word (a broadcast). Activations are staged through shared
// memory, RC rows of K at a time. The tensor-core routes of W4, Q8 and flash
// attention pick their own tiles (their launch plans) and share the cp.async,
// ldmatrix and mma helpers at the end of this file.
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

// The int8-activation kernels (W4A8, W8A8) stage kChunk8 K rows of int8
// activations at a time, each row padded by one word so that the per-row
// sums read shared memory without bank conflicts. The dot products run on
// __dp4a: four K values of x (one word of a staged row) against four K
// values of one weight column, packed by transpose4x4.
constexpr int kChunk8 = 64;
constexpr int kRow8 = kChunk8 + 4;
// Words (4 K rows each) of weight loads started before any is used, so that
// one trip to device memory serves 16 rows.
constexpr int kBatch8 = 4;

// Stage int8 x[m0 : m0+BM, k0 : k0+rc] into dst[BM][kRow8], zero outside the
// matrix and past rc (so a word that straddles rc sums only real values).
template <int BM>
__device__ __forceinline__ void stage_rows_i8(int8_t (*dst)[kRow8], const int8_t* __restrict__ x,
                                              int M, int ld, int m0, int k0, int rc, int tid) {
  for (int i = tid; i < BM * kChunk8; i += kThreads) {
    const int m = i / kChunk8;
    const int r = i % kChunk8;
    int8_t v = 0;
    if (m0 + m < M && r < rc) v = x[static_cast<size_t>(m0 + m) * ld + k0 + r];
    dst[m][r] = v;
  }
}

// Word j of a staged int8 row: x at K offsets 4j .. 4j+3, lowest byte first.
__device__ __forceinline__ int staged_word(const int8_t* row, int j) {
  return reinterpret_cast<const int*>(row)[j];
}

// rows[j] holds byte c of weight row j for column c; cols[c] gets byte j of
// rows[j]: the four K values of column c in __dp4a order.
__device__ __forceinline__ void transpose4x4(const uint32_t rows[4], uint32_t cols[4]) {
  const uint32_t a = __byte_perm(rows[0], rows[1], 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
  const uint32_t b = __byte_perm(rows[2], rows[3], 0x5140);  // r2.b0 r3.b0 r2.b1 r3.b1
  const uint32_t c = __byte_perm(rows[0], rows[1], 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
  const uint32_t d = __byte_perm(rows[2], rows[3], 0x7362);  // r2.b2 r3.b2 r2.b3 r3.b3
  cols[0] = __byte_perm(a, b, 0x5410);
  cols[1] = __byte_perm(a, b, 0x7632);
  cols[2] = __byte_perm(c, d, 0x5410);
  cols[3] = __byte_perm(c, d, 0x7632);
}

// ---- tensor-core routes: asynchronous copies and fragment loads ----------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 matrices of 16-bit elements (8 rows of 16 bytes each): lanes
// 8i..8i+7 give the row addresses of matrix i, register i gets matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_u32(p)));
}

// The same four matrices, each transposed: register i of lane (g, t) holds
// elements (2t, g) and (2t + 1, g) of matrix i (a B fragment from k-major rows).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_u32(p)));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), float32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace oqt
