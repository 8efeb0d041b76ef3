// W8A8 matmul for Hopper (sm_90a): int8 activations times symmetric 8-bit weights.
//
// Replaces the Pallas kernel onnx_quantize_tpu/ops/kernels/matmul_w8a8.py
// (_w8a8_call -> _w8a8_kernel). The activations arrive quantized per tensor
// (x_q int8 in [-127, 127], one float32 scale sx). The weights are
// symmetric: int8 with zero point 0, or uint8 with zero point 128, which the
// load shifts into int8 (u ^ 0x80 == u - 128 as a signed byte), as the
// reference's shift does. Each K tile of bk rows (the group for a group
// scale, all of K for a channel or tensor scale) is dotted fully in int32
// and then scaled once:
//     acc += float(x_q . w over the tile) * (sx * s_row).
// The reference cuts a whole-K tile into 512-row steps; that only changes
// float32 rounding, so the port keeps whole tiles. The epilogue uses rounded
// intrinsics in the plain version's order, so the two agree bit for bit.
//
// Shapes: x_q (M, ldx) int8, ldx >= K with zeros past K; sx a float32
// scalar on the device; w (K, N) int8/uint8; scale (K / bk, N) float32;
// out (M, N) float32.
//
// What bounds it on the card: bytes, at both of the main path's shapes. The
// Gemma-3-270M lm_head (K = 640, N = 262144) reads 168 MB of int8 weights and
// writes 33.5 MB of float32 logits at decode (M = 32, ~60 us at 3.35 TB/s),
// and writes 2.15 GB of float32 logits for a 2048-token scoring window
// (~0.64 ms; its 0.69 TOP of int8 products take ~0.35 ms at 1,979 TOP/s).
// Two routes, chosen by the launch plan (ops/kernels/matmul_w8a8.py::w8a8_plan):
//
// mma (N % 16 == 0, 16-byte-aligned weights and x rows, and a K tile that is
//   all of K or a multiple of 32 rows): tensor cores, on the s8 core of the
//   Q8 kernel (common.cuh).
//   - mma.sync m16n8k32 s8 x s8 -> s32, without .satfinite: |x_q| <= 127 and
//     shifted weights |w| <= 128 keep a tile's |acc| < 2^31 for bk < 2^17
//     (the wrapper raises above that).
//   - Weight rows go through the core's cp.async ring (zero-filled past K),
//     each lane's B words made by transpose4x4 in the core's permuted k order.
//     The core's A fragments must come in that same order, and cp.async copies
//     bytes as they lie, so x_q passes through registers: a thread loads 16
//     codes a chunk (one 16-byte load; chunks past ldx or M load as 0) and
//     stores them permuted (one transpose4x4); the next stage's loads are in
//     flight while the current stage multiplies. The wrapper pads x_q's rows
//     to a multiple of 16 bytes with zero codes, which add nothing to a dot.
//   - The K tile is a hard boundary: after the last slice of each tile the
//     int32 tile sums are folded into float32 accumulators with
//     __fmul_rn(sx, s) and __fadd_rn(acc, __fmul_rn(float(d), s)), tile after
//     tile, as the simt route and the plain version do; a single tile (a
//     channel or tensor scale) keeps no float32 accumulator and folds once in
//     the epilogue.
//   - Tiles: 32 x 64 (32 x 32 where those number fewer than the SMs) up to
//     M = 64; above, 128 x 128 (64 x 128 where those number fewer than the
//     SMs). The lm_head launches 4,096 blocks at M = 32 and 32,768 at
//     M = 2048, so K (640) is never split.
//   - A lane's C fragments hold 8 adjacent columns of two rows: the epilogue
//     stores them as two float4s, and the four lanes of a quad write 128
//     contiguous bytes of a row.
//
// simt (anything else): the CUDA-core kernel of the first port. Each thread
//   owns CPT adjacent columns and RPT rows of M (common.cuh's block shape);
//   the inner loop starts the loads of 16 weight rows of the thread's
//   columns, then takes them four at a time, transposes them into one word
//   per column and runs __dp4a against the staged x_q words.

#include "common.cuh"

namespace {

using oqt::kBatch8;
using oqt::kChunk8;
using oqt::kRow8;
using oqt::kThreadsM;
using oqt::kThreadsN;

template <int RPT, int CPT>
__global__ void __launch_bounds__(oqt::kThreads)
w8a8_simt_kernel(const int8_t* __restrict__ x, const float* __restrict__ sx_ptr,
                 const uint8_t* __restrict__ w, const float* __restrict__ scale,
                 float* __restrict__ out, int M, int K, int N, int ldx, int bk,
                 uint32_t flip) {
  constexpr int BM = RPT * kThreadsM;
  __shared__ __align__(16) int8_t xs[BM][kRow8];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kThreadsN + tx;
  const int col0 = (blockIdx.x * kThreadsN + tx) * CPT;
  const int m0 = blockIdx.y * BM;
  const bool col_ok = col0 < N;  // CPT == 4 only when N % 4 == 0
  const int n_tiles = K / bk;
  const float sx = *sx_ptr;

  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    int d[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) d[i][c] = 0;

    for (int r0 = 0; r0 < bk; r0 += kChunk8) {
      const int rc = min(kChunk8, bk - r0);
      __syncthreads();  // the previous chunk is consumed
      oqt::stage_rows_i8<BM>(xs, x, M, ldx, m0, t * bk + r0, rc, tid);
      __syncthreads();
      if (!col_ok) continue;
      const int words = (rc + 3) / 4;
      const uint8_t* wchunk = w + static_cast<size_t>(t * bk + r0) * N + col0;
      for (int j0 = 0; j0 < words; j0 += kBatch8) {
        // All loads of kBatch8 words first; rows past rc (and words past
        // `words`) meet x staged as zero, and their load is skipped.
        uint32_t rows[kBatch8][4];
#pragma unroll
        for (int b = 0; b < kBatch8; ++b)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int r = 4 * (j0 + b) + q;
            rows[b][q] =
                (r < rc ? oqt::load_bytes<CPT>(wchunk + static_cast<size_t>(r) * N) : 0u) ^ flip;
          }
#pragma unroll
        for (int b = 0; b < kBatch8; ++b) {
          uint32_t cols[4];
          oqt::transpose4x4(rows[b], cols);
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const int xv = oqt::staged_word(xs[ty + i * kThreadsM], j0 + b);
#pragma unroll
            for (int c = 0; c < CPT; ++c)
              d[i][c] = __dp4a(xv, static_cast<int>(cols[c]), d[i][c]);
          }
        }
      }
    }
    if (col_ok) {
      // Rounded operations in the plain version's order: bit-equal results.
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float s = __fmul_rn(sx, scale[static_cast<size_t>(t) * N + col0 + c]);
#pragma unroll
        for (int i = 0; i < RPT; ++i)
          acc[i][c] = __fadd_rn(acc[i][c], __fmul_rn(static_cast<float>(d[i][c]), s));
      }
    }
  }

  if (!col_ok) return;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int m = m0 + ty + i * kThreadsM;
    if (m >= M) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c) out[static_cast<size_t>(m) * N + col0 + c] = acc[i][c];
  }
}

template <int RPT, int CPT>
int launch_simt(const void* x, const void* sx, const void* w, const void* s, void* out, int M,
                int K, int N, int ldx, int bk, uint32_t flip, cudaStream_t stream) {
  constexpr int BM = RPT * kThreadsM;
  const dim3 grid((N + kThreadsN * CPT - 1) / (kThreadsN * CPT), (M + BM - 1) / BM);
  const dim3 block(kThreadsN, kThreadsM);
  w8a8_simt_kernel<RPT, CPT><<<grid, block, 0, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const float*>(sx),
      static_cast<const uint8_t*>(w), static_cast<const float*>(s), static_cast<float*>(out), M,
      K, N, ldx, bk, flip);
  return static_cast<int>(cudaGetLastError());
}

// ---- mma route ----------------------------------------------------------------

constexpr int kSliceK = oqt::kS8SliceK;
constexpr int kStageK = oqt::kS8StageK;
constexpr int kWStages = oqt::kS8WStages;
constexpr int kXPitch = oqt::kS8XPitch;

// The operands of one call (kernel parameter space).
struct W8A8Args {
  const int8_t* x;
  const float* sx;
  const uint8_t* w;
  const float* scale;
  float* out;
  int M, K, N;
  int ldx;          // x_q row pitch: a multiple of 16, zeros past K
  int tile_slices;  // 32-row slices of a K tile (bk / 32)
  uint32_t flip;    // 0x80808080 for uint8 weights, else 0
};

// ONE_TILE: the K tile is all of K (a channel or tensor scale).
template <int WM, int WARPS_M, int WARPS_N, bool ONE_TILE>
__global__ void __launch_bounds__(32 * WARPS_M * WARPS_N) w8a8_mma_kernel(const W8A8Args p) {
  using Tl = oqt::S8Tile<WM, WARPS_M, WARPS_N>;
  extern __shared__ __align__(16) uint8_t smem[];
  int8_t* xbuf = reinterpret_cast<int8_t*>(smem + kWStages * Tl::kWBytes);  // two x tiles

  const int M = p.M, K = p.K, N = p.N;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp / WARPS_N, warp_n = warp % WARPS_N;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * Tl::kBN, m0 = blockIdx.y * Tl::kBM;
  const int k_end = (K + kSliceK - 1) / kSliceK * kSliceK;  // whole slices; zeros past K
  const int n_stages = (k_end + kStageK - 1) / kStageK;
  // This lane's C columns col0 .. col0 + 7 (N % 16 == 0: all in or all out).
  const int col0 = n0 + warp_n * 32 + 8 * t;
  const bool col_ok = col0 < N;
  const float sx = *p.sx;

  // sx * s_row of K tile `tile` for the lane's eight columns.
  auto tile_scales = [&](int tile, float (&s)[8]) {
    const float* row = p.scale + static_cast<size_t>(tile) * N + col0;
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = col_ok ? __fmul_rn(sx, __ldg(row + i)) : 0.f;
  };

  // Chunk c of a stage: row c / 4, codes 16 (c % 4) .. + 15; 0 past ldx or M.
  uint4 xr[Tl::kXChunks];
  auto load_x = [&](int s) {
#pragma unroll
    for (int i = 0; i < Tl::kXChunks; ++i) {
      const int c = tid + i * Tl::kThreads;
      const int m = m0 + (c >> 2);
      const int k = s * kStageK + 16 * (c & 3);
      xr[i] = m < M && k < p.ldx
                  ? __ldg(reinterpret_cast<const uint4*>(p.x + static_cast<size_t>(m) * p.ldx + k))
                  : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto stage_x = [&](int s) {
    int8_t* dst = xbuf + (s & 1) * Tl::kXBytes;
#pragma unroll
    for (int i = 0; i < Tl::kXChunks; ++i) {
      const int c = tid + i * Tl::kThreads;
      const uint32_t words[4] = {xr[i].x, xr[i].y, xr[i].z, xr[i].w};
      oqt::s8_stage_permuted(dst + (c >> 2) * kXPitch + 16 * (c & 3), words);
    }
  };
  auto load_w = [&](int s) {
    const int k0 = s * kStageK;
    oqt::s8_load_w<Tl>(smem + (s % kWStages) * Tl::kWBytes, p.w, k0, min(kStageK, k_end - k0), K,
                       N, n0, tid);
  };

  int acc[WM][4][4];
  float facc[WM][4][4];  // the folded tiles (unused for ONE_TILE)
#pragma unroll
  for (int mt = 0; mt < WM; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[mt][j][e] = 0;
        facc[mt][j][e] = 0.f;
      }

#pragma unroll
  for (int s = 0; s < kWStages - 1; ++s) {
    if (s < n_stages) load_w(s);
    oqt::cp_async_commit();
  }
  load_x(0);
  for (int s = 0; s < n_stages; ++s) {
    // x tile s & 1 was last read by stage s - 2, before the previous barrier.
    stage_x(s);
    if (s + 1 < n_stages) load_x(s + 1);  // in flight while stage s multiplies
    oqt::cp_async_wait<kWStages - 2>();
    __syncthreads();  // stage s landed; every warp is done with stage s - 1
    if (s + kWStages - 1 < n_stages) load_w(s + kWStages - 1);
    oqt::cp_async_commit();

    const uint8_t* wb = smem + (s % kWStages) * Tl::kWBytes;
    const int8_t* xb = xbuf + (s & 1) * Tl::kXBytes;
    const int ns = min(kStageK / kSliceK, (k_end - s * kStageK) / kSliceK);
    for (int sl = 0; sl < ns; ++sl) {
      oqt::s8_mma_slice<Tl>(acc, xb, wb, sl, warp_m, warp_n, lane, p.flip);
      if constexpr (!ONE_TILE) {
        const int slice = s * (kStageK / kSliceK) + sl;
        if ((slice + 1) % p.tile_slices == 0) {
          // The tile's last slice: fold its int32 sums in the plain order.
          float sc[8];
          tile_scales(slice / p.tile_slices, sc);
#pragma unroll
          for (int mt = 0; mt < WM; ++mt)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                facc[mt][j][e] = __fadd_rn(
                    facc[mt][j][e],
                    __fmul_rn(static_cast<float>(acc[mt][j][e]), sc[4 * (e & 1) + j]));
                acc[mt][j][e] = 0;
              }
        }
      }
    }
  }
  oqt::cp_async_wait<0>();
  if (!col_ok) return;

  float sc[8];
  if constexpr (ONE_TILE) tile_scales(0, sc);
#pragma unroll
  for (int mt = 0; mt < WM; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + (warp_m * WM + mt) * 16 + g + 8 * h;
      if (m >= M) continue;
      float o[8];
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int e = 2 * h + q;
          if constexpr (ONE_TILE) {
            // The plain version's single term: float(d) * (sx * s_row).
            o[4 * q + j] = __fmul_rn(static_cast<float>(acc[mt][j][e]), sc[4 * q + j]);
          } else {
            o[4 * q + j] = facc[mt][j][e];
          }
        }
      float4* dst = reinterpret_cast<float4*>(p.out + static_cast<size_t>(m) * N + col0);
      dst[0] = make_float4(o[0], o[1], o[2], o[3]);
      dst[1] = make_float4(o[4], o[5], o[6], o[7]);
    }
}

template <int WM, int WARPS_M, int WARPS_N, bool ONE_TILE>
int launch_mma(const W8A8Args& p, cudaStream_t stream) {
  using Tl = oqt::S8Tile<WM, WARPS_M, WARPS_N>;
  auto kernel = w8a8_mma_kernel<WM, WARPS_M, WARPS_N, ONE_TILE>;
  if (Tl::kRingBytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::kRingBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((p.N + Tl::kBN - 1) / Tl::kBN, (p.M + Tl::kBM - 1) / Tl::kBM);
  kernel<<<grid, Tl::kThreads, Tl::kRingBytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool ONE_TILE>
int dispatch_mma(const W8A8Args& p, int bm, int bn, cudaStream_t st) {
  if (bm == 32 && bn == 32) return launch_mma<1, 2, 1, ONE_TILE>(p, st);
  if (bm == 32 && bn == 64) return launch_mma<1, 2, 2, ONE_TILE>(p, st);
  if (bm == 64 && bn == 128) return launch_mma<2, 2, 4, ONE_TILE>(p, st);
  if (bm == 128 && bn == 128) return launch_mma<4, 2, 4, ONE_TILE>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x: int8 (M, ldx), zeros past K; sx: one float32 on the device. is_signed:
// int8 weights (1) or uint8 with zero point 128 (0). The launch plan
// (ops/kernels/matmul_w8a8.py::w8a8_plan): route 1 is the mma route (N % 16
// == 0, w and x 16-byte aligned, ldx % 16 == 0, bk == K or bk % 32 == 0,
// bk < 2^17), 0 the simt route; bm, bn the block tile (simt: bm 32 or 64
// rows, bn 128 for four columns a thread, which needs N % 4 == 0, else 32).
// Returns cudaGetLastError() after the launch.
extern "C" int oqt_w8a8_matmul(const void* x, const void* sx, const void* w, const void* scale,
                               void* out, int M, int K, int N, int ldx, int bk, int is_signed,
                               int route, int bm, int bn, void* stream) {
  const uint32_t flip = is_signed ? 0u : 0x80808080u;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    const bool one_tile = bk == K;
    if (N % 16 != 0 || ldx % 16 != 0 || ldx < K || bk >= (1 << 17) ||
        (!one_tile && bk % kSliceK != 0))
      return static_cast<int>(cudaErrorInvalidValue);
    if (reinterpret_cast<uintptr_t>(w) % 16 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
    const W8A8Args p{static_cast<const int8_t*>(x),
                     static_cast<const float*>(sx),
                     static_cast<const uint8_t*>(w),
                     static_cast<const float*>(scale),
                     static_cast<float*>(out),
                     M,
                     K,
                     N,
                     ldx,
                     one_tile ? 0 : bk / kSliceK,
                     flip};
    return one_tile ? dispatch_mma<true>(p, bm, bn, st) : dispatch_mma<false>(p, bm, bn, st);
  }
  const bool cols4 = bn == 128;
  if (bm <= 32) {
    return cols4 ? launch_simt<4, 4>(x, sx, w, scale, out, M, K, N, ldx, bk, flip, st)
                 : launch_simt<4, 1>(x, sx, w, scale, out, M, K, N, ldx, bk, flip, st);
  }
  return cols4 ? launch_simt<8, 4>(x, sx, w, scale, out, M, K, N, ldx, bk, flip, st)
               : launch_simt<8, 1>(x, sx, w, scale, out, M, K, N, ldx, bk, flip, st);
}
