// W4A8 matmul for Hopper (sm_90a): int8 activations times packed 4-bit weights.
//
// Replaces the Pallas kernel onnx_quantize_tpu/ops/kernels/matmul_w4a8.py
// (_w4a8_call -> _w4a8_kernel). The activations arrive quantized per tensor
// (x_q int8 in [-127, 127], one float32 scale sx, from
// quantize_activation_int8 in the wrapper's module). The weights are in the
// group-pair nibble layout of the W4 kernel: packed row p*gs + r holds
// logical row (2p)*gs + r in its low nibble (scale group 2p) and
// (2p+1)*gs + r in its high nibble (group 2p+1). The raw nibbles (0..15 for
// uint4, sign-extended -8..7 for int4) are dotted against x_q in int32, and
// the integer zero point folds in through the int32 sum of x_q:
//     x . ((w - zp) * s) == (x_q . w - sum(x_q) * zp) * (sx * s),
// so per group pair and output
//     acc += (dot_lo - xsum_lo * z_lo) * (sx * s_lo) + (dot_hi - xsum_hi * z_hi) * (sx * s_hi).
// Every int32 partial stays below 2^24 (127 * 15 * 128 = 243,840 at gs = 128),
// so the integer part is exact and only the float32 order of the group sums
// can differ from the reference. The float32 epilogue is written with
// rounded intrinsics in the plain version's order, so kernel and plain
// version agree bit for bit: in a bf16 stream a last-bit difference can move
// an int8 activation code of a later site, and comparisons of whole models
// would otherwise measure that amplification rather than the kernel.
//
// Shapes: x_q (M, K_pad) int8, zero past K; sx a float32 scalar on the
// device; w (K_pad / 2, N) uint8; scale and zp (G_pad/2, 2, N) float32, pad
// groups (1, 0); out (M, N) float32.
//
// What bounds it on the card: bytes. One Gemma-3-270M layer's four sites at
// decode (M = 32) read ~3.5 MB of packed weights and scales and write ~0.9 MB
// of float32 (~1.4 us at 3.35 TB/s); at a 32x128 prefill (M = 4096) they
// write 115 MB of float32 outputs (~35 us), while their int8 products take
// ~12 us at 1,979 TOP/s. Two routes, chosen by the launch plan
// (ops/kernels/matmul_w4a8.py::w4a8_plan):
//
// mma (N % 16 == 0, a group size that is a multiple of 32, 16-byte-aligned
//   x_q and w, K_pad < 2^17): tensor cores, on the s8 core of the Q8 and
//   W8A8 kernels (common.cuh).
//   - mma.sync m16n8k32 s8 x s8 -> s32, without .satfinite (|x_q| <= 127,
//     |nibble| <= 15). A slice is 32 packed rows inside one group pair; its
//     staged weight words feed two mmas: the low nibbles (uint4 as they
//     are, int4 sign-extended bytewise) against x_q columns 2p*gs + r ..,
//     the high nibbles against (2p+1)*gs + r ... The nibbles are widened
//     before the core's transpose4x4, so B takes the core's permuted k
//     order, and both x_q tiles are staged in it (s8_stage_permuted, from
//     16-byte register loads in flight while the previous stage multiplies).
//   - sum(x_q) of each group comes exact from an s8 mma of the staged tile
//     against a B of ones.
//   - One block a tile: at each pair change the int32 sums fold into float32
//     in the plain version's order and operations (as above).
//   - K split at decode, until the grid has a block for every 8/3 SMs (at
//     M = 32 the 270M qkv site launches 72 blocks, o and down 60, gate_up its
//     64 tiles unsplit): a split's atomics and the last block's serial fold
//     cost more than more blocks gain (exploration on the card: a layer's
//     four sites 0.061 ms against 0.074 with a block per SM). int32 sums are
//     exact in any order, float folds are not, so a split adds its per-group
//     int32 dots
//     and row sums into the tile's scratch (integer atomics: the same sums
//     whatever the order), fences and counts itself on the tile's counter;
//     the last block to arrive folds every pair in order, as one block
//     would, stores, and sets the scratch and the counter back to 0, which
//     keeps the launch replayable in a CUDA graph.
//   - Tiles: 32 rows by 64 columns up to M = 64 (two warps along M, each
//     widening the block's weight words: half the registers of one warp
//     holding all 32 rows, and faster at decode), by 128 above (one warp along
//     M, each weight word widened once a block).
//
// simt (anything else): the CUDA-core kernel of the first port. One block
//   covers 32 * CPT columns and BM <= 64 rows of M and walks every group pair
//   itself. The inner loop starts the loads of 16 packed rows of the
//   thread's columns, then takes them four at a time: splits and
//   sign-extends the nibbles bytewise, transposes them into one word per
//   column and runs __dp4a.

#include "common.cuh"

namespace {

using oqt::kBatch8;
using oqt::kChunk8;
using oqt::kRow8;
using oqt::kThreadsM;
using oqt::kThreadsN;
using oqt::ldmatrix_x4;

// Low or high nibbles of four bytes, sign-extended bytewise when sign is
// 0x08080808 (int4: (n ^ 8) - 8); sign 0 leaves uint4 nibbles as they are.
__device__ __forceinline__ uint32_t nibbles(uint32_t bytes, int shift, uint32_t sign) {
  return __vsub4(((bytes >> shift) & 0x0F0F0F0Fu) ^ sign, sign);
}

template <int RPT, int CPT>
__global__ void __launch_bounds__(oqt::kThreads)
w4a8_kernel(const int8_t* __restrict__ x, const float* __restrict__ sx_ptr,
            const uint8_t* __restrict__ w, const float* __restrict__ scale,
            const float* __restrict__ zp, float* __restrict__ out, int M, int K_pad, int N,
            int gs, uint32_t sign) {
  constexpr int BM = RPT * kThreadsM;
  __shared__ __align__(16) int8_t xs[2][BM][kRow8];
  __shared__ int xsum[2][BM];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kThreadsN + tx;
  const int col0 = (blockIdx.x * kThreadsN + tx) * CPT;
  const int m0 = blockIdx.y * BM;
  const bool col_ok = col0 < N;  // CPT == 4 only when N % 4 == 0
  const int n_pairs = K_pad / (2 * gs);
  const float sx = *sx_ptr;

  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  for (int p = 0; p < n_pairs; ++p) {
    int dlo[RPT][CPT], dhi[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) dlo[i][c] = dhi[i][c] = 0;

    __syncthreads();  // the previous pair's epilogue has read xsum
    if (tid < 2 * BM) xsum[tid / BM][tid % BM] = 0;

    for (int r0 = 0; r0 < gs; r0 += kChunk8) {
      const int rc = min(kChunk8, gs - r0);
      __syncthreads();  // the previous chunk is consumed
      oqt::stage_rows_i8<BM>(xs[0], x, M, K_pad, m0, (2 * p) * gs + r0, rc, tid);
      oqt::stage_rows_i8<BM>(xs[1], x, M, K_pad, m0, (2 * p + 1) * gs + r0, rc, tid);
      __syncthreads();
      const int words = (rc + 3) / 4;
      if (tid < 2 * BM) {
        const int h = tid / BM, m = tid % BM;
        int s = 0;
        for (int j = 0; j < words; ++j) s = __dp4a(oqt::staged_word(xs[h][m], j), 0x01010101, s);
        xsum[h][m] += s;
      }
      if (col_ok) {
        const uint8_t* wchunk = w + static_cast<size_t>(p * gs + r0) * N + col0;
        for (int j0 = 0; j0 < words; j0 += kBatch8) {
          // All loads of kBatch8 words first. Rows past rc belong to the next
          // group (or lie past the array): their load is skipped, and they
          // (like words past `words`) meet x staged as zero.
          uint32_t bytes[kBatch8][4];
#pragma unroll
          for (int b = 0; b < kBatch8; ++b)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int r = 4 * (j0 + b) + q;
              bytes[b][q] = r < rc ? oqt::load_bytes<CPT>(wchunk + static_cast<size_t>(r) * N)
                                   : 0u;
            }
#pragma unroll
          for (int b = 0; b < kBatch8; ++b) {
            uint32_t lo_rows[4], hi_rows[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              lo_rows[q] = nibbles(bytes[b][q], 0, sign);
              hi_rows[q] = nibbles(bytes[b][q], 4, sign);
            }
            uint32_t lo[4], hi[4];
            oqt::transpose4x4(lo_rows, lo);
            oqt::transpose4x4(hi_rows, hi);
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
              const int m = ty + i * kThreadsM;
              const int xl = oqt::staged_word(xs[0][m], j0 + b);
              const int xh = oqt::staged_word(xs[1][m], j0 + b);
#pragma unroll
              for (int c = 0; c < CPT; ++c) {
                dlo[i][c] = __dp4a(xl, static_cast<int>(lo[c]), dlo[i][c]);
                dhi[i][c] = __dp4a(xh, static_cast<int>(hi[c]), dhi[i][c]);
              }
            }
          }
        }
      }
    }
    __syncthreads();  // xsum is complete
    if (col_ok) {
      // Rounded operations (no FMA contraction), in the plain version's order,
      // so that the two agree bit for bit.
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const size_t lo_row = static_cast<size_t>(2 * p) * N + col0 + c;
        const float s_lo = __fmul_rn(sx, scale[lo_row]), z_lo = zp[lo_row];
        const float s_hi = __fmul_rn(sx, scale[lo_row + N]), z_hi = zp[lo_row + N];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int m = ty + i * kThreadsM;
          const float t_lo = __fmul_rn(
              __fsub_rn(static_cast<float>(dlo[i][c]),
                        __fmul_rn(static_cast<float>(xsum[0][m]), z_lo)), s_lo);
          const float t_hi = __fmul_rn(
              __fsub_rn(static_cast<float>(dhi[i][c]),
                        __fmul_rn(static_cast<float>(xsum[1][m]), z_hi)), s_hi);
          acc[i][c] = __fadd_rn(acc[i][c], __fadd_rn(t_lo, t_hi));
        }
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
int launch_simt(const void* x, const void* sx, const void* w, const void* s, const void* z,
                void* out, int M, int K_pad, int N, int gs, uint32_t sign, cudaStream_t stream) {
  constexpr int BM = RPT * kThreadsM;
  const dim3 grid((N + kThreadsN * CPT - 1) / (kThreadsN * CPT), (M + BM - 1) / BM);
  const dim3 block(kThreadsN, kThreadsM);
  w4a8_kernel<RPT, CPT><<<grid, block, 0, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const float*>(sx),
      static_cast<const uint8_t*>(w), static_cast<const float*>(s), static_cast<const float*>(z),
      static_cast<float*>(out), M, K_pad, N, gs, sign);
  return static_cast<int>(cudaGetLastError());
}

// ---- mma route ----------------------------------------------------------------

constexpr int kSliceK = oqt::kS8SliceK;  // packed rows a slice
constexpr int kStageK = oqt::kS8StageK;  // packed rows a pipeline stage
constexpr int kWStages = oqt::kS8WStages;
constexpr int kXPitch = oqt::kS8XPitch;
constexpr uint32_t kOnes8 = 0x01010101u;  // four s8 ones

// The operands of one call (kernel parameter space).
struct W4A8Args {
  const int8_t* x;
  const float* sx;
  const uint8_t* w;
  const float* scale;
  const float* zp;
  float* out;
  int* ws;                 // K split: per-group int32 dots, then row sums
  unsigned int* counters;  // K split: one counter a tile, 0 between launches
  int M, K_pad, N, gs;
  int split_slices;  // 32-row slices of packed rows a block walks
  uint32_t sign;     // 0x08080808 for int4 (sign-extend the nibbles), else 0
};

// The weight ring and, for two stages, the low- and high-group x_q tiles.
template <class Tl>
constexpr int smem_bytes() {
  return kWStages * Tl::kWBytes + 4 * Tl::kXBytes;
}

template <int WM, int WARPS_M, int WARPS_N>
__global__ void __launch_bounds__(32 * WARPS_M * WARPS_N) w4a8_mma_kernel(const W4A8Args p) {
  using Tl = oqt::S8Tile<WM, WARPS_M, WARPS_N>;
  constexpr int kTileElems = Tl::kBM * Tl::kBN;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ unsigned int s_last;
  int8_t* xbuf = reinterpret_cast<int8_t*>(smem + kWStages * Tl::kWBytes);

  const int M = p.M, N = p.N, gs = p.gs;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp / WARPS_N, warp_n = warp % WARPS_N;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * Tl::kBN, m0 = blockIdx.y * Tl::kBM;
  const int half_rows = p.K_pad / 2;
  // This block's packed rows [r_begin, r_end): whole slices (gs % 32 == 0).
  const int r_begin = blockIdx.z * p.split_slices * kSliceK;
  const int r_end = min(half_rows, r_begin + p.split_slices * kSliceK);
  const int n_stages = (r_end - r_begin + kStageK - 1) / kStageK;
  // This lane's C columns col0 .. col0 + 7: element e of n-tile j is column
  // col0 + 4 (e & 1) + j (N % 16 == 0: all eight in or all out).
  const int col0 = n0 + warp_n * 32 + 8 * t;
  const bool col_ok = col0 < N;
  const float sx = *p.sx;
  const int splits = gridDim.z;
  const int tile_id = blockIdx.y * gridDim.x + blockIdx.x;
  const int groups = p.K_pad / gs;
  // K split scratch: the tile's dots (group, fragment order) and row sums.
  int* tile_dots = p.ws + static_cast<size_t>(tile_id) * groups * kTileElems;
  int* tile_xsum = p.ws + static_cast<size_t>(gridDim.x) * gridDim.y * groups * kTileElems +
                   static_cast<size_t>(tile_id) * groups * Tl::kBM;

  // Chunk c of a stage: row c >> 2, packed rows 16 (c & 3) .. + 15 of the
  // stage, and its x_q codes of the low and the high group; 0 past M or the
  // block's rows.
  uint4 xr[2][Tl::kXChunks];
  auto load_x = [&](int s) {
#pragma unroll
    for (int i = 0; i < Tl::kXChunks; ++i) {
      const int c = tid + i * Tl::kThreads;
      const int m = m0 + (c >> 2);
      const int pr = r_begin + s * kStageK + 16 * (c & 3);
      const bool ok = m < M && pr < r_end;
      const int pair = pr / gs;
      const int8_t* src = p.x + static_cast<size_t>(m) * p.K_pad + 2 * pair * gs + (pr - pair * gs);
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
      xr[0][i] = ok ? __ldg(reinterpret_cast<const uint4*>(src)) : zero;
      xr[1][i] = ok ? __ldg(reinterpret_cast<const uint4*>(src + gs)) : zero;
    }
  };
  auto stage_x = [&](int s) {
    int8_t* dst = xbuf + (s & 1) * 2 * Tl::kXBytes;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < Tl::kXChunks; ++i) {
        const int c = tid + i * Tl::kThreads;
        const uint32_t words[4] = {xr[h][i].x, xr[h][i].y, xr[h][i].z, xr[h][i].w};
        oqt::s8_stage_permuted(dst + h * Tl::kXBytes + (c >> 2) * kXPitch + 16 * (c & 3), words);
      }
  };
  auto load_w = [&](int s) {
    const int r0 = r_begin + s * kStageK;
    oqt::s8_load_w<Tl>(smem + (s % kWStages) * Tl::kWBytes, p.w, r0, min(kStageK, r_end - r0),
                       half_rows, N, n0, tid);
  };

  int dlo[WM][4][4], dhi[WM][4][4], xlo[WM][4], xhi[WM][4];
  float facc[WM][4][4];
#pragma unroll
  for (int mt = 0; mt < WM; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      xlo[mt][e] = xhi[mt][e] = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dlo[mt][j][e] = dhi[mt][j][e] = 0;
        facc[mt][j][e] = 0.f;
      }
    }
  auto clear = [&]() {
#pragma unroll
    for (int mt = 0; mt < WM; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        xlo[mt][e] = xhi[mt][e] = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) dlo[mt][j][e] = dhi[mt][j][e] = 0;
      }
  };
  auto fold = [&](int pair) {
    float slo[8], zlo[8], shi[8], zhi[8];
    const size_t row = static_cast<size_t>(2 * pair) * N + col0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      slo[i] = col_ok ? __fmul_rn(sx, __ldg(p.scale + row + i)) : 0.f;
      zlo[i] = col_ok ? __ldg(p.zp + row + i) : 0.f;
      shi[i] = col_ok ? __fmul_rn(sx, __ldg(p.scale + row + N + i)) : 0.f;
      zhi[i] = col_ok ? __ldg(p.zp + row + N + i) : 0.f;
    }
#pragma unroll
    for (int mt = 0; mt < WM; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * (e & 1) + j;
          const float t_lo = __fmul_rn(
              __fsub_rn(static_cast<float>(dlo[mt][j][e]),
                        __fmul_rn(static_cast<float>(xlo[mt][e & 2]), zlo[i])), slo[i]);
          const float t_hi = __fmul_rn(
              __fsub_rn(static_cast<float>(dhi[mt][j][e]),
                        __fmul_rn(static_cast<float>(xhi[mt][e & 2]), zhi[i])), shi[i]);
          facc[mt][j][e] = __fadd_rn(facc[mt][j][e], __fadd_rn(t_lo, t_hi));
        }
  };
  // The pair's int32 sums: folded (one block a tile) or added to the tile's
  // scratch (K split); either way they restart.
  auto flush = [&](int pair) {
    if (splits == 1) {
      fold(pair);
    } else {
      int* dots = tile_dots + static_cast<size_t>(2 * pair) * kTileElems;
#pragma unroll
      for (int mt = 0; mt < WM; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int idx = ((mt * 4 + j) * Tl::kThreads + tid) * 4 + e;
            atomicAdd(dots + idx, dlo[mt][j][e]);
            atomicAdd(dots + kTileElems + idx, dhi[mt][j][e]);
          }
      if (t == 0 && warp_n == 0) {
        int* xs = tile_xsum + static_cast<size_t>(2 * pair) * Tl::kBM;
#pragma unroll
        for (int mt = 0; mt < WM; ++mt) {
          const int r = (warp_m * WM + mt) * 16 + g;
          atomicAdd(xs + r, xlo[mt][0]);
          atomicAdd(xs + r + 8, xlo[mt][2]);
          atomicAdd(xs + Tl::kBM + r, xhi[mt][0]);
          atomicAdd(xs + Tl::kBM + r + 8, xhi[mt][2]);
        }
      }
    }
    clear();
  };

  // One 32-row slice sl of a stage: the low and high nibbles of the staged
  // weight words against the two staged x_q tiles, and both row sums.
  auto slice = [&](const int8_t* xb, const uint8_t* wb, int sl) {
    uint32_t alo[WM][4], ahi[WM][4];
#pragma unroll
    for (int mt = 0; mt < WM; ++mt) {
      const int8_t* a = xb + ((warp_m * WM + mt) * 16 + (lane & 15)) * kXPitch + sl * kSliceK +
                        (lane >> 4) * 16;
      ldmatrix_x4(alo[mt], a);
      ldmatrix_x4(ahi[mt], a + Tl::kXBytes);
    }
    // Rows t + 4q (b0) and 16 + t + 4q (b1) of the slice, columns 4g .. 4g + 3
    // of the warp's 32.
    const uint8_t* wr = wb + (sl * kSliceK + t) * Tl::kWPitch + warp_n * 32 + 4 * g;
    uint32_t raw0[4], raw1[4], rows[4], blo0[4], blo1[4], bhi0[4], bhi1[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      raw0[q] = *reinterpret_cast<const uint32_t*>(wr + 4 * q * Tl::kWPitch);
      raw1[q] = *reinterpret_cast<const uint32_t*>(wr + (16 + 4 * q) * Tl::kWPitch);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) rows[q] = nibbles(raw0[q], 0, p.sign);
    oqt::transpose4x4(rows, blo0);
#pragma unroll
    for (int q = 0; q < 4; ++q) rows[q] = nibbles(raw1[q], 0, p.sign);
    oqt::transpose4x4(rows, blo1);
#pragma unroll
    for (int q = 0; q < 4; ++q) rows[q] = nibbles(raw0[q], 4, p.sign);
    oqt::transpose4x4(rows, bhi0);
#pragma unroll
    for (int q = 0; q < 4; ++q) rows[q] = nibbles(raw1[q], 4, p.sign);
    oqt::transpose4x4(rows, bhi1);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int mt = 0; mt < WM; ++mt) {
        oqt::mma_s8(dlo[mt][j], alo[mt], blo0[j], blo1[j]);
        oqt::mma_s8(dhi[mt][j], ahi[mt], bhi0[j], bhi1[j]);
      }
#pragma unroll
    for (int mt = 0; mt < WM; ++mt) {
      oqt::mma_s8(xlo[mt], alo[mt], kOnes8, kOnes8);
      oqt::mma_s8(xhi[mt], ahi[mt], kOnes8, kOnes8);
    }
  };

#pragma unroll
  for (int s = 0; s < kWStages - 1; ++s) {
    if (s < n_stages) load_w(s);
    oqt::cp_async_commit();
  }
  load_x(0);
  int cur = r_begin / gs;
  for (int s = 0; s < n_stages; ++s) {
    // x tiles s & 1 were last read by stage s - 2, before the previous barrier.
    stage_x(s);
    if (s + 1 < n_stages) load_x(s + 1);  // in flight while stage s multiplies
    oqt::cp_async_wait<kWStages - 2>();
    __syncthreads();  // stage s landed; every warp is done with stage s - 1
    if (s + kWStages - 1 < n_stages) load_w(s + kWStages - 1);
    oqt::cp_async_commit();

    const uint8_t* wb = smem + (s % kWStages) * Tl::kWBytes;
    const int8_t* xb = xbuf + (s & 1) * 2 * Tl::kXBytes;
    const int r0 = r_begin + s * kStageK;
    const int ns = min(kStageK, r_end - r0) / kSliceK;
    for (int sl = 0; sl < ns; ++sl) {
      const int pair = (r0 + sl * kSliceK) / gs;
      if (pair != cur) {
        flush(cur);
        cur = pair;
      }
      slice(xb, wb, sl);
    }
  }
  oqt::cp_async_wait<0>();
  flush(cur);

  if (splits > 1) {
    __threadfence();  // the sums are visible device-wide before the count
    __syncthreads();
    if (tid == 0)
      s_last = atomicAdd(p.counters + tile_id, 1u) == static_cast<unsigned>(splits - 1);
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    for (int pair = 0; pair < groups / 2; ++pair) {
      int* dots = tile_dots + static_cast<size_t>(2 * pair) * kTileElems;
      const int* xs = tile_xsum + static_cast<size_t>(2 * pair) * Tl::kBM;
#pragma unroll
      for (int mt = 0; mt < WM; ++mt) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          int4* lo = reinterpret_cast<int4*>(dots) + (mt * 4 + j) * Tl::kThreads + tid;
          int4* hi = reinterpret_cast<int4*>(dots + kTileElems) + (mt * 4 + j) * Tl::kThreads + tid;
          const int4 vl = __ldcg(lo), vh = __ldcg(hi);
          dlo[mt][j][0] = vl.x, dlo[mt][j][1] = vl.y, dlo[mt][j][2] = vl.z, dlo[mt][j][3] = vl.w;
          dhi[mt][j][0] = vh.x, dhi[mt][j][1] = vh.y, dhi[mt][j][2] = vh.z, dhi[mt][j][3] = vh.w;
          __stcg(lo, make_int4(0, 0, 0, 0));
          __stcg(hi, make_int4(0, 0, 0, 0));
        }
        const int r = (warp_m * WM + mt) * 16 + g;
        xlo[mt][0] = __ldcg(xs + r);
        xlo[mt][2] = __ldcg(xs + r + 8);
        xhi[mt][0] = __ldcg(xs + Tl::kBM + r);
        xhi[mt][2] = __ldcg(xs + Tl::kBM + r + 8);
      }
      fold(pair);
    }
    __syncthreads();  // every thread has read the row sums
    for (int i = tid; i < groups * Tl::kBM; i += Tl::kThreads) __stcg(tile_xsum + i, 0);
    if (tid == 0) p.counters[tile_id] = 0u;  // ready for the next launch (or graph replay)
  }
  if (!col_ok) return;
#pragma unroll
  for (int mt = 0; mt < WM; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + (warp_m * WM + mt) * 16 + g + 8 * h;
      if (m >= M) continue;
      float4* dst = reinterpret_cast<float4*>(p.out + static_cast<size_t>(m) * N + col0);
      dst[0] = make_float4(facc[mt][0][2 * h], facc[mt][1][2 * h], facc[mt][2][2 * h],
                           facc[mt][3][2 * h]);
      dst[1] = make_float4(facc[mt][0][2 * h + 1], facc[mt][1][2 * h + 1],
                           facc[mt][2][2 * h + 1], facc[mt][3][2 * h + 1]);
    }
}

template <int WM, int WARPS_M, int WARPS_N>
int launch_mma(const W4A8Args& p, cudaStream_t stream) {
  using Tl = oqt::S8Tile<WM, WARPS_M, WARPS_N>;
  constexpr int kSmem = smem_bytes<Tl>();
  auto kernel = w4a8_mma_kernel<WM, WARPS_M, WARPS_N>;
  if (kSmem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int slices = p.K_pad / 2 / kSliceK;
  const int splits = (slices + p.split_slices - 1) / p.split_slices;
  const dim3 grid((p.N + Tl::kBN - 1) / Tl::kBN, (p.M + Tl::kBM - 1) / Tl::kBM, splits);
  kernel<<<grid, Tl::kThreads, kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The tiles of the plan: 32 rows by 64 or 128 columns, one warp along M.
// The tiles of the plan: 32 x 64 (two warps along M, 128 registers a
// thread) and 32 x 128 (one warp along M).
int dispatch_mma(const W4A8Args& p, int bm, int bn, cudaStream_t st) {
  if (bm == 32 && bn == 64) return launch_mma<1, 2, 2>(p, st);
  if (bm == 32 && bn == 128) return launch_mma<2, 1, 4>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x: int8 (M, K_pad); sx: one float32 on the device. is_signed: int4 (1) or
// uint4 (0). The launch plan (ops/kernels/matmul_w4a8.py::w4a8_plan): route 1
// is the mma route (N % 16 == 0, gs % 32 == 0, x and w 16-byte aligned,
// K_pad < 2^17), 0 the simt route; bm, bn the block tile (simt: bm 32 or 64
// rows, bn 128 for four columns a thread, which needs N % 4 == 0, else 32);
// split_slices the 32-row slices of packed rows a block walks (mma route; the
// grid has ceil(K_pad / 64 / split_slices) blocks along K). When the plan
// splits K, ws holds tiles * groups * (bm * bn + bm) int32 and counters one
// uint32 a tile, all 0 (each launch leaves them so); both may be null
// otherwise. Returns cudaGetLastError() after the launch.
extern "C" int oqt_w4a8_matmul(const void* x, const void* sx, const void* w, const void* scale,
                               const void* zp, void* out, int M, int K_pad, int N, int gs,
                               int is_signed, int route, int bm, int bn, int split_slices,
                               void* ws, void* counters, void* stream) {
  const uint32_t sign = is_signed ? 0x08080808u : 0u;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (N % 16 != 0 || gs % kSliceK != 0 || K_pad % (2 * gs) != 0 || K_pad >= (1 << 17) ||
        split_slices <= 0)
      return static_cast<int>(cudaErrorInvalidValue);
    if (reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
    if (K_pad / 2 / kSliceK > split_slices && (ws == nullptr || counters == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    const W4A8Args p{static_cast<const int8_t*>(x),
                     static_cast<const float*>(sx),
                     static_cast<const uint8_t*>(w),
                     static_cast<const float*>(scale),
                     static_cast<const float*>(zp),
                     static_cast<float*>(out),
                     static_cast<int*>(ws),
                     static_cast<unsigned int*>(counters),
                     M,
                     K_pad,
                     N,
                     gs,
                     split_slices,
                     sign};
    return dispatch_mma(p, bm, bn, st);
  }
  const bool cols4 = bn == 128;
  if (bm <= 32) {
    return cols4 ? launch_simt<4, 4>(x, sx, w, scale, zp, out, M, K_pad, N, gs, sign, st)
                 : launch_simt<4, 1>(x, sx, w, scale, zp, out, M, K_pad, N, gs, sign, st);
  }
  return cols4 ? launch_simt<8, 4>(x, sx, w, scale, zp, out, M, K_pad, N, gs, sign, st)
               : launch_simt<8, 1>(x, sx, w, scale, zp, out, M, K_pad, N, gs, sign, st);
}
