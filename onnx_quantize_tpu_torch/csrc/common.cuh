// Shared pieces of the hand-written matmul kernels.
//
// The CUDA-core (simt) routes of W4, W8, W4A8, W8A8 and Q8 use one block
// shape: 32 threads along N (one warp reads consecutive columns of a weight
// row, so its loads coalesce) times 8 warps along M. Each thread owns CPT
// adjacent columns and RPT rows of M, strided by 8 so that a warp's reads of
// the staged activations all hit the same shared-memory word (a broadcast).
// Activations are staged through shared memory, RC rows of K at a time. The
// tensor-core routes of W4, W8, W4A8, W8A8, Q8, the fused MLP and flash
// attention pick their own tiles (their launch plans) and share the cp.async,
// ldmatrix and mma helpers at the end of this file; W4 and the fused MLP share
// the nibble-to-bf16 operand builder, and Q8, W8A8 and W4A8 the s8 mma core.
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

// d = a * b + c on bf16x2 registers, one rounding (exact where the result is).
__device__ __forceinline__ uint32_t bf16x2_fma(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

constexpr uint32_t kBf16x2Ones = 0x3F803F80u;  // bf16x2 (1, 1)

// Byte j of the words a (row k) and b (row k + 1) of a column, as two bf16x2
// registers (row k in the low half): the low nibbles and the high nibbles,
// each exact. nib_bits is 0x43004300 (uint4) or 0x43084308 (int4: nib ^ 8);
// neg_off is bf16x2 (-128, -128) or (-136, -136). The W4 and fused-MLP mma
// routes build their B operands with it.
__device__ __forceinline__ void nibble_pairs(uint32_t a, uint32_t b, uint32_t sel,
                                             uint32_t nib_bits, uint32_t neg_off, uint32_t& lo,
                                             uint32_t& hi) {
  const uint32_t p = __byte_perm(a, b, sel);  // a.j a.j b.j b.j
  lo = bf16x2_fma((p & 0x000F000Fu) ^ nib_bits, kBf16x2Ones, neg_off);
  hi = bf16x2_fma(((p >> 12) & 0x000F000Fu) ^ nib_bits, kBf16x2Ones, neg_off);
}

// ---- the s8 tensor-core core of the Q8 and W8A8 mma routes --------------------
//
// mma.sync m16n8k32 s8 x s8 -> s32. Weight rows (n contiguous) go through
// shared memory by 16-byte cp.async in a ring of kS8WStages stages of 64 rows.
// A B register needs four k of one column: a lane loads four 32-bit words
// (four rows of four adjacent columns) and transpose4x4 turns them into one
// register for each of its four n-tiles (lane g feeds column 4g + j of n-tile
// j); uint8 words are XORed with 0x80808080 first. Inside each 16-row half of
// a slice the mma's k order is permuted: lane t holds rows t, t + 4, t + 8,
// t + 12, so the four lanes of a group read consecutive rows, which a row
// pitch of 8 (mod 32) words puts 8 banks apart. x codes are staged in the same
// order (s8_stage_permuted), and A fragments come by ldmatrix. A lane's C
// fragments hold 8 adjacent columns of two rows: element e of n-tile j is
// column 8t + 4 (e & 1) + j of the warp's 32, row g + 8 (e >> 1).

constexpr int kS8SliceK = 32;              // K rows of one mma (m16n8k32)
constexpr int kS8StageK = 64;              // K rows a pipeline stage: two slices
constexpr int kS8WStages = 3;              // cp.async ring depth of the weight rows
constexpr int kS8XPitch = kS8StageK + 16;  // bytes a staged x row: ldmatrix's 8 rows
                                           // fall in distinct bank groups

// A block of WARPS_M x WARPS_N warps; a warp owns WM m-tiles of 16 rows and
// 32 columns (four n-tiles of 8).
template <int WM, int WARPS_M, int WARPS_N>
struct S8Tile {
  static constexpr int kWM = WM;
  static constexpr int kWarpsN = WARPS_N;
  static constexpr int kBM = WM * 16 * WARPS_M;
  static constexpr int kBN = 32 * WARPS_N;
  static constexpr int kThreads = 32 * WARPS_M * WARPS_N;
  // Staged weight rows: kBN bytes padded to a pitch of 8 (mod 32) words.
  static constexpr int kWPitch = kBN == 32 ? 32 : kBN + 32;
  static constexpr int kWBytes = kS8StageK * kWPitch;
  static constexpr int kXBytes = kBM * kS8XPitch;
  // 16-code x chunks a thread stages per stage; four chunks make a row.
  static constexpr int kXChunks = kBM * (kS8StageK / 16) / kThreads;
  // The weight ring and two x tiles.
  static constexpr int kRingBytes = kS8WStages * kWBytes + 2 * kXBytes;
  static_assert(kXChunks * kThreads == kBM * (kS8StageK / 16), "x chunks split evenly");
  static_assert((kWPitch / 4) % 32 == 8 || (kWPitch / 4) % 32 == 24, "bank-spread pitch");
};

// c += a (16x32 s8, row) * b (32x8 s8, col), int32 accumulate.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Weight rows [k0, k0 + rows) of columns [n0, n0 + kBN) into one ring stage by
// 16-byte cp.async; rows past K and columns past N are zero-filled (N % 16 ==
// 0: a chunk is all in or all out).
template <class Tl>
__device__ __forceinline__ void s8_load_w(uint8_t* dst, const uint8_t* __restrict__ w, int k0,
                                          int rows, int K, int N, int n0, int tid) {
  constexpr int kRowChunks = Tl::kBN / 16;
  for (int i = tid; i < rows * kRowChunks; i += Tl::kThreads) {
    const int r = i / kRowChunks, ch = i % kRowChunks;
    const int col = n0 + ch * 16;
    const bool ok = k0 + r < K && col < N;
    cp_async16(dst + r * Tl::kWPitch + ch * 16, ok ? w + static_cast<size_t>(k0 + r) * N + col : w,
               ok);
  }
}

// 16 consecutive s8 codes of an x row (words[q] holds codes 4q .. 4q + 3,
// lowest byte first) to dst in the mma's k order: position 4t + q holds code
// t + 4q.
__device__ __forceinline__ void s8_stage_permuted(int8_t* dst, const uint32_t (&words)[4]) {
  uint32_t cols[4];
  transpose4x4(words, cols);
  *reinterpret_cast<uint4*>(dst) = make_uint4(cols[0], cols[1], cols[2], cols[3]);
}

// One 32-row slice sl of a stage: the warp's WM x 4 mmas from the staged x
// tile xb (permuted k) and weight stage wb.
template <class Tl>
__device__ __forceinline__ void s8_mma_slice(int (&acc)[Tl::kWM][4][4], const int8_t* xb,
                                             const uint8_t* wb, int sl, int warp_m, int warp_n,
                                             int lane, uint32_t flip) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t a[Tl::kWM][4];
#pragma unroll
  for (int mt = 0; mt < Tl::kWM; ++mt)
    ldmatrix_x4(a[mt], xb + ((warp_m * Tl::kWM + mt) * 16 + (lane & 15)) * kS8XPitch +
                           sl * kS8SliceK + (lane >> 4) * 16);
  // Rows t + 4q (b0) and 16 + t + 4q (b1) of the slice, columns 4g .. 4g + 3
  // of the warp's 32.
  const uint8_t* wr = wb + (sl * kS8SliceK + t) * Tl::kWPitch + warp_n * 32 + 4 * g;
  uint32_t lo[4], hi[4], b0[4], b1[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    lo[q] = *reinterpret_cast<const uint32_t*>(wr + 4 * q * Tl::kWPitch) ^ flip;
    hi[q] = *reinterpret_cast<const uint32_t*>(wr + (16 + 4 * q) * Tl::kWPitch) ^ flip;
  }
  transpose4x4(lo, b0);
  transpose4x4(hi, b1);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int mt = 0; mt < Tl::kWM; ++mt) mma_s8(acc[mt][j], a[mt], b0[j], b1[j]);
}

}  // namespace oqt
