// Full-integer QLINEAR matmul (Q8) for Hopper (sm_90a).
//
// Replaces the Pallas kernel onnx_quantize_tpu/ops/kernels/matmul_q8.py
// (_q8_call -> _q8_kernel). One launch computes a whole QLINEAR site:
//   1. static input quantization while x is staged: q = rint(x / x_scale) +
//      x_zp, clamped to the input type's range, then shifted into int8
//      (uint8 codes minus 128); x is read as float32 (a bf16 x exactly),
//      the division is IEEE (__fdiv_rn) and rint rounds half to even;
//   2. the s8 x s8 dot in int32 (uint8 weights flipped into int8 by XOR 0x80);
//   3. the zero-point corrections and the int32 bias, exact in int32:
//        acc - x_zp*wsum - w_zp*xsum + K*x_zp*w_zp + b
//      (x_zp and w_zp shifted with their codes, wsum the column sums of the
//      shifted weights, xsum the row sums of the staged codes);
//   4. requantization by req = x_scale*w_scale/y_scale (one float32 per
//      column, computed once by the wrapper), rint, + y_zp, clamp to the
//      output type's range, and the dequantization (y_q - y_zp) * y_scale.
//
// Shapes: x (M, K) float32 or bfloat16; w (K, N) int8/uint8; wsum, w_zp
// (N,) int32; req (N,) float32; bias (N,) int32 or null; fparams
// [x_scale, y_scale] and iparams [x_zp, y_zp] on the device (no host sync);
// out (M, N) float32.
//
// What bounds it on the card: bytes, at both of the main path's shapes. At
// decode (M = 32) a Gemma-3-270M layer's seven sites read 5.57 MB of int8
// weights (~1.7 us at 3.35 TB/s). At prefill (M = 4096) they write 113 MB of
// float32 outputs and read 51 MB of bf16 x (~51 us), while their 45.6 GOP of
// int8 products take ~23 us at 1,979 TOP/s. Two routes, chosen by the launch
// plan (ops/kernels/matmul_q8.py::q8_plan):
//
// mma (N % 16 == 0, 16-byte-aligned weights): tensor cores, on the s8 core
// that W8A8 shares (common.cuh).
//   - mma.sync m16n8k32 s8 x s8 -> s32, without .satfinite: shifted codes
//     keep |acc| <= 128 * 128 * K < 2^31 for K < 2^17 (the wrapper raises
//     above that).
//   - x is quantized while it is staged: 16 values a thread go from device
//     memory to registers, through the IEEE divide, __float2int_rn, + x_zp,
//     the clamp and the shift, into shared memory as s8 codes, k contiguous;
//     A fragments come by ldmatrix. The next stage's x loads are in flight
//     while the current stage multiplies. Codes past K (or past the block's K
//     range) and rows past M stage as 0, so they add nothing to the dots or
//     the row sums: xsum counts only real codes, and K * x_zp * w_zp keeps
//     the true K. Each thread sums the codes it stages; the four lanes that
//     stage a row give its sum by two shuffles.
//   - Weight rows go through shared memory by 16-byte cp.async (zero-filled
//     past K) in a ring of three stages of 64 rows. A B register needs four
//     k of one column, and the weights hold n contiguous: a lane loads four
//     32-bit words (four rows of four adjacent columns) and transpose4x4
//     turns them into one register for each of its four n-tiles (lane g
//     feeds column 4g + j of n-tile j, W4's mapping); uint8 words are XORed
//     with 0x80808080 first. Inside each 16-row half of a slice the mma's k
//     order is permuted: lane t holds rows t, t + 4, t + 8, t + 12, so the
//     four lanes of a group read consecutive rows, which a row pitch of 8
//     (mod 32) words puts 8 banks apart. x is staged in the same order (one
//     more transpose4x4 of its 16 codes).
//   - A lane's C fragments hold 8 adjacent columns of two rows, so the
//     epilogue stores float4s straight from registers.
//   - At decode (M <= 64) the plan splits K in whole 32-row slices until the
//     grid has a block per SM (every 270M site at M = 32 launches 160 blocks;
//     the k and v sites take 32-column tiles for it). Each split block folds
//     its own -w_zp * xsum_part into its int32 partial tile (the correction is
//     linear), writes it to scratch, fences and counts itself on the tile's
//     counter; the last to arrive sums the partials, adds -x_zp * wsum +
//     K * x_zp * w_zp + bias, runs the epilogue and sets the counter back to
//     0, which keeps the launch replayable in a CUDA graph. One launch: no
//     memset, no second pass, no atomics on out.
//   - Large M takes 128 x 128 tiles (64 x 128 where those number fewer than
//     the SMs) and no split.
//
// simt (N % 16 != 0, or weights off a 16-byte boundary): the CUDA-core
//   kernel of the first port, the dot on __dp4a, the weights loaded as the
//   W8A8 kernel loads them.
//
// Why the bits hold: int32 sums are exact, so neither the tile shape, the k
// order nor the K split changes a bit. The float epilogue runs once per
// output element in the plain version's order: __int2float_rn, __fmul_rn by
// req, rintf, __fadd_rn of y_zp, the clamp, __fsub_rn of y_zp, __fmul_rn by
// y_scale. So the result equals the plain version's and the JAX oracle's bit
// for bit on both routes.

#include "common.cuh"

namespace {

using oqt::kBatch8;
using oqt::kChunk8;
using oqt::kRow8;
using oqt::kThreadsM;
using oqt::kThreadsN;

// The operands and constants of one call (kernel parameter space).
struct Q8Args {
  const void* x;
  const uint8_t* w;
  const int* wsum;
  const int* wzp;
  const float* req;
  const int* bias;  // may be null
  const float* fparams;
  const int* iparams;
  float* out;
  int* ws;                 // K split: partial tiles (mma route)
  unsigned int* counters;  // K split: one counter a tile, 0 between launches
  int M, K, N;
  uint32_t flip;  // 0x80808080 for uint8 weights, else 0
  int x_shift, iqmin, iqmax, oqmin, oqmax;
  int split_slices;  // mma route: 32-row slices of K a block walks
  int x_vec;         // x rows 16-byte aligned: 16-byte loads
};

struct QuantIn {
  float scale;
  int zp, qmin, qmax, shift;
};

// One input value to its shifted s8 code.
__device__ __forceinline__ int quantize(float f, const QuantIn& qi) {
  const int q = __float2int_rn(__fdiv_rn(f, qi.scale)) + qi.zp;
  return min(max(q, qi.qmin), qi.qmax) - qi.shift;
}

struct QuantOut {
  float y_scale, y_zp, lo, hi;
};

// The requantization and dequantization of one corrected int32 sum, one
// rounded operation at a time in the plain version's order.
__device__ __forceinline__ float requantize(int acc, float rq, const QuantOut& qo) {
  const float yq =
      fminf(fmaxf(__fadd_rn(rintf(__fmul_rn(__int2float_rn(acc), rq)), qo.y_zp), qo.lo), qo.hi);
  return __fmul_rn(__fsub_rn(yq, qo.y_zp), qo.y_scale);
}

__device__ __forceinline__ QuantIn quant_in(const Q8Args& p) {
  return QuantIn{p.fparams[0], p.iparams[0], p.iqmin, p.iqmax, p.x_shift};
}

__device__ __forceinline__ QuantOut quant_out(const Q8Args& p) {
  return QuantOut{p.fparams[1], static_cast<float>(p.iparams[1]), static_cast<float>(p.oqmin),
                  static_cast<float>(p.oqmax)};
}

// ---- simt route ---------------------------------------------------------------

// Stage x[m0 : m0+BM, k0 : k0+rc] into dst[BM][kRow8] as shifted int8 codes,
// zero outside the matrix and past rc (zeros add nothing to the dots or the
// row sums).
template <typename T, int BM>
__device__ __forceinline__ void stage_quantized(int8_t (*dst)[kRow8], const T* __restrict__ x,
                                                int M, int K, int m0, int k0, int rc, int tid,
                                                const QuantIn& qi) {
  for (int i = tid; i < BM * kChunk8; i += oqt::kThreads) {
    const int m = i / kChunk8;
    const int r = i % kChunk8;
    int v = 0;
    if (m0 + m < M && r < rc)
      v = quantize(oqt::to_f32(x[static_cast<size_t>(m0 + m) * K + k0 + r]), qi);
    dst[m][r] = static_cast<int8_t>(v);
  }
}

// 32 x 8 threads, each owning CPT adjacent columns and RPT rows of M strided
// by 8, K staged 64 rows at a time.
template <typename T, int RPT, int CPT>
__global__ void __launch_bounds__(oqt::kThreads) q8_kernel(const Q8Args p) {
  constexpr int BM = RPT * kThreadsM;
  __shared__ __align__(16) int8_t xs[BM][kRow8];
  __shared__ int xsum[BM];

  const T* __restrict__ x = static_cast<const T*>(p.x);
  const int M = p.M, K = p.K, N = p.N;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kThreadsN + tx;
  const int col0 = (blockIdx.x * kThreadsN + tx) * CPT;
  const int m0 = blockIdx.y * BM;
  const bool col_ok = col0 < N;  // CPT == 4 only when N % 4 == 0
  const QuantIn qi = quant_in(p);

  int d[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) d[i][c] = 0;
  int row_sum = 0;  // thread tid < BM: the sum of row tid's staged codes

  for (int r0 = 0; r0 < K; r0 += kChunk8) {
    const int rc = min(kChunk8, K - r0);
    __syncthreads();  // the previous chunk is consumed
    stage_quantized<T, BM>(xs, x, M, K, m0, r0, rc, tid, qi);
    __syncthreads();
    if (tid < BM) {
#pragma unroll
      for (int j = 0; j < kChunk8 / 4; ++j)
        row_sum = __dp4a(oqt::staged_word(xs[tid], j), 0x01010101, row_sum);
    }
    if (!col_ok) continue;
    const int words = (rc + 3) / 4;
    const uint8_t* wchunk = p.w + static_cast<size_t>(r0) * N + col0;
    for (int j0 = 0; j0 < words; j0 += kBatch8) {
      // All loads of kBatch8 words first; rows past rc meet x staged as
      // zero, and their load is skipped.
      uint32_t rows[kBatch8][4];
#pragma unroll
      for (int b = 0; b < kBatch8; ++b)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = 4 * (j0 + b) + q;
          rows[b][q] =
              (r < rc ? oqt::load_bytes<CPT>(wchunk + static_cast<size_t>(r) * N) : 0u) ^ p.flip;
        }
#pragma unroll
      for (int b = 0; b < kBatch8; ++b) {
        uint32_t cols[4];
        oqt::transpose4x4(rows[b], cols);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int xv = oqt::staged_word(xs[ty + i * kThreadsM], j0 + b);
#pragma unroll
          for (int c = 0; c < CPT; ++c) d[i][c] = __dp4a(xv, static_cast<int>(cols[c]), d[i][c]);
        }
      }
    }
  }
  if (tid < BM) xsum[tid] = row_sum;
  __syncthreads();
  if (!col_ok) return;

  const int x_zp = p.iparams[0] - p.x_shift;
  const QuantOut qo = quant_out(p);
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int n = col0 + c;
    const int zw = p.wzp[n];
    const int fixed = -x_zp * p.wsum[n] + K * x_zp * zw + (p.bias != nullptr ? p.bias[n] : 0);
    const float rq = p.req[n];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int m = m0 + ty + i * kThreadsM;
      if (m >= M) continue;
      const int acc = d[i][c] - zw * xsum[ty + i * kThreadsM] + fixed;
      p.out[static_cast<size_t>(m) * N + n] = requantize(acc, rq, qo);
    }
  }
}

template <typename T, int RPT, int CPT>
int launch_simt(const Q8Args& p, cudaStream_t stream) {
  constexpr int BM = RPT * kThreadsM;
  const dim3 grid((p.N + kThreadsN * CPT - 1) / (kThreadsN * CPT), (p.M + BM - 1) / BM);
  q8_kernel<T, RPT, CPT><<<grid, dim3(kThreadsN, kThreadsM), 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// bm: 32 or 64 rows a block; bn: 32 (one column a thread) or 128 (four).
template <typename T>
int dispatch_simt(const Q8Args& p, int bm, int bn, cudaStream_t st) {
  if (bm <= 32) return bn == 128 ? launch_simt<T, 4, 4>(p, st) : launch_simt<T, 4, 1>(p, st);
  return bn == 128 ? launch_simt<T, 8, 4>(p, st) : launch_simt<T, 8, 1>(p, st);
}

// ---- mma route ----------------------------------------------------------------

constexpr int kSliceK = oqt::kS8SliceK;
constexpr int kStageK = oqt::kS8StageK;
constexpr int kWStages = oqt::kS8WStages;
constexpr int kXPitch = oqt::kS8XPitch;

// The shared s8 tile (common.cuh) and the row sums of the staged codes.
template <int WM, int WARPS_M, int WARPS_N>
struct Q8Tile : oqt::S8Tile<WM, WARPS_M, WARPS_N> {
  using Base = oqt::S8Tile<WM, WARPS_M, WARPS_N>;
  static constexpr int kSmem = Base::kRingBytes + Base::kBM * 4;
};

// 16 consecutive values of one x row as loaded (float32: 16 words; bf16: 8),
// and how many of them lie inside the matrix and the block's K range.
template <typename T>
struct XChunk {
  static constexpr int kWords = 4 * static_cast<int>(sizeof(T));
  uint32_t w[kWords];
  int valid;

  __device__ __forceinline__ void load(const T* __restrict__ row, int k, int k_lim, bool row_ok,
                                       bool vec) {
    valid = row_ok ? max(0, min(16, k_lim - k)) : 0;
    if (vec && valid == 16) {
      const uint4* src = reinterpret_cast<const uint4*>(row + k);
#pragma unroll
      for (int i = 0; i < kWords / 4; ++i) {
        const uint4 v = __ldg(src + i);
        w[4 * i] = v.x;
        w[4 * i + 1] = v.y;
        w[4 * i + 2] = v.z;
        w[4 * i + 3] = v.w;
      }
      return;
    }
    // The K tail, or rows that 16-byte loads cannot read.
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = 0u;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      if (e >= valid) continue;
      if constexpr (sizeof(T) == 4) {
        w[e] = __float_as_uint(row[k + e]);
      } else {
        w[e >> 1] |= static_cast<uint32_t>(__bfloat16_as_ushort(row[k + e])) << (16 * (e & 1));
      }
    }
  }

  __device__ __forceinline__ float value(int e) const {
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(w[e]);
    } else {
      return __uint_as_float((e & 1) ? (w[e >> 1] & 0xFFFF0000u) : (w[e >> 1] << 16));
    }
  }

  // The 16 shifted codes (0 where not valid) to dst in the mma's k order:
  // position 4t + q holds value t + 4q. Returns their sum.
  __device__ __forceinline__ int stage(int8_t* dst, const QuantIn& qi) const {
    uint32_t words[4];
    int sum = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t word = 0u;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int e = 4 * q + b;
        const int v = e < valid ? quantize(value(e), qi) : 0;
        sum += v;
        word |= (static_cast<uint32_t>(v) & 0xFFu) << (8 * b);
      }
      words[q] = word;
    }
    oqt::s8_stage_permuted(dst, words);
    return sum;
  }
};

template <typename T, int WM, int WARPS_M, int WARPS_N>
__global__ void __launch_bounds__(32 * WARPS_M * WARPS_N) q8_mma_kernel(const Q8Args p) {
  using Tl = Q8Tile<WM, WARPS_M, WARPS_N>;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ unsigned int s_last;
  int8_t* xbuf = reinterpret_cast<int8_t*>(smem + kWStages * Tl::kWBytes);  // two x tiles
  int* xsum = reinterpret_cast<int*>(smem + kWStages * Tl::kWBytes + 2 * Tl::kXBytes);

  const T* __restrict__ x = static_cast<const T*>(p.x);
  const uint8_t* __restrict__ w = p.w;
  const int M = p.M, K = p.K, N = p.N;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp / WARPS_N, warp_n = warp % WARPS_N;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * Tl::kBN, m0 = blockIdx.y * Tl::kBM;
  // This block's K range [k_begin, k_end), whole slices; values past K are 0.
  const int k_begin = blockIdx.z * p.split_slices * kSliceK;
  const int k_end = min((K + kSliceK - 1) / kSliceK * kSliceK, k_begin + p.split_slices * kSliceK);
  const int k_lim = min(K, k_end);
  const int n_stages = (k_end - k_begin + kStageK - 1) / kStageK;
  const QuantIn qi = quant_in(p);

  auto load_w = [&](int s) {
    const int k0 = k_begin + s * kStageK;
    oqt::s8_load_w<Tl>(smem + (s % kWStages) * Tl::kWBytes, w, k0, min(kStageK, k_end - k0), K,
                       N, n0, tid);
  };

  // Chunk c of a stage: row c / 4, columns 16 (c % 4) .. + 15.
  XChunk<T> xc[Tl::kXChunks];
  int xsum_part[Tl::kXChunks];
#pragma unroll
  for (int i = 0; i < Tl::kXChunks; ++i) xsum_part[i] = 0;
  auto load_x = [&](int s) {
    const int k0 = k_begin + s * kStageK;
#pragma unroll
    for (int i = 0; i < Tl::kXChunks; ++i) {
      const int c = tid + i * Tl::kThreads;
      const int m = m0 + (c >> 2);
      xc[i].load(x + static_cast<size_t>(m) * K, k0 + 16 * (c & 3), k_lim, m < M, p.x_vec != 0);
    }
  };
  auto stage_x = [&](int s) {
    int8_t* dst = xbuf + (s & 1) * Tl::kXBytes;
#pragma unroll
    for (int i = 0; i < Tl::kXChunks; ++i) {
      const int c = tid + i * Tl::kThreads;
      xsum_part[i] += xc[i].stage(dst + (c >> 2) * kXPitch + 16 * (c & 3), qi);
    }
  };

  int acc[WM][4][4];
#pragma unroll
  for (int mt = 0; mt < WM; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0;

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
    const int ns = min(kStageK / kSliceK, (k_end - k_begin - s * kStageK) / kSliceK);
    for (int sl = 0; sl < ns; ++sl)
      oqt::s8_mma_slice<Tl>(acc, xb, wb, sl, warp_m, warp_n, lane, p.flip);
  }
  oqt::cp_async_wait<0>();

  // The block's row sums: the four lanes that stage a row hold its parts.
#pragma unroll
  for (int i = 0; i < Tl::kXChunks; ++i) {
    int sum = xsum_part[i];
    sum += __shfl_xor_sync(0xFFFFFFFFu, sum, 1);
    sum += __shfl_xor_sync(0xFFFFFFFFu, sum, 2);
    if ((tid & 3) == 0) xsum[(tid + i * Tl::kThreads) >> 2] = sum;
  }
  __syncthreads();

  // This lane's C elements: rows g and g + 8 of each m-tile; element e of
  // n-tile j is column col0 + 4 (e & 1) + j, eight adjacent columns.
  const int col0 = n0 + warp_n * 32 + 8 * t;
  const bool col_ok = col0 < N;  // N % 16 == 0: all eight in or all out
  int zw[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) zw[i] = col_ok ? p.wzp[col0 + i] : 0;
#pragma unroll
  for (int mt = 0; mt < WM; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[mt][j][e] -= zw[4 * (e & 1) + j] * xsum[(warp_m * WM + mt) * 16 + g + 8 * (e >> 1)];

  const int splits = gridDim.z;
  if (splits > 1) {
    // K split: this block's folded partial to scratch (fragment order: int4
    // i of every thread, then i + 1); the last block of the tile to arrive
    // sums all partials.
    constexpr int kTileVecs = Tl::kBM * Tl::kBN / 4;
    const int tile_id = blockIdx.y * gridDim.x + blockIdx.x;
    int4* parts = reinterpret_cast<int4*>(p.ws) + static_cast<size_t>(tile_id) * splits * kTileVecs;
    int4* mine = parts + static_cast<size_t>(blockIdx.z) * kTileVecs;
#pragma unroll
    for (int mt = 0; mt < WM; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mine[(mt * 4 + j) * Tl::kThreads + tid] =
            make_int4(acc[mt][j][0], acc[mt][j][1], acc[mt][j][2], acc[mt][j][3]);
    __threadfence();  // the partial is visible device-wide before the count
    __syncthreads();
    if (tid == 0)
      s_last = atomicAdd(p.counters + tile_id, 1u) == static_cast<unsigned>(splits - 1);
    __syncthreads();
    if (!s_last) return;
    __threadfence();
#pragma unroll
    for (int mt = 0; mt < WM; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0;
#pragma unroll 4
    for (int z = 0; z < splits; ++z) {
      const int4* part = parts + static_cast<size_t>(z) * kTileVecs;
#pragma unroll
      for (int mt = 0; mt < WM; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int4 v = __ldcg(part + (mt * 4 + j) * Tl::kThreads + tid);
          acc[mt][j][0] += v.x;
          acc[mt][j][1] += v.y;
          acc[mt][j][2] += v.z;
          acc[mt][j][3] += v.w;
        }
    }
    if (tid == 0) p.counters[tile_id] = 0u;  // ready for the next launch (or graph replay)
  }
  if (!col_ok) return;

  const int x_zp = p.iparams[0] - p.x_shift;
  const QuantOut qo = quant_out(p);
  int fixed[8];
  float rq[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int n = col0 + i;
    fixed[i] = -x_zp * p.wsum[n] + K * x_zp * zw[i] + (p.bias != nullptr ? p.bias[n] : 0);
    rq[i] = p.req[n];
  }
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
        for (int j = 0; j < 4; ++j)
          o[4 * q + j] = requantize(acc[mt][j][2 * h + q] + fixed[4 * q + j], rq[4 * q + j], qo);
      float4* dst = reinterpret_cast<float4*>(p.out + static_cast<size_t>(m) * N + col0);
      dst[0] = make_float4(o[0], o[1], o[2], o[3]);
      dst[1] = make_float4(o[4], o[5], o[6], o[7]);
    }
}

template <typename T, int WM, int WARPS_M, int WARPS_N>
int launch_mma(const Q8Args& p, cudaStream_t stream) {
  using Tl = Q8Tile<WM, WARPS_M, WARPS_N>;
  auto kernel = q8_mma_kernel<T, WM, WARPS_M, WARPS_N>;
  if (Tl::kSmem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int slices = (p.K + kSliceK - 1) / kSliceK;
  const int splits = (slices + p.split_slices - 1) / p.split_slices;
  const dim3 grid((p.N + Tl::kBN - 1) / Tl::kBN, (p.M + Tl::kBM - 1) / Tl::kBM, splits);
  kernel<<<grid, Tl::kThreads, Tl::kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The tiles of the plan: 32 x 32, 32 x 64, 64 x 128, 128 x 128.
template <typename T>
int dispatch_mma(const Q8Args& p, int bm, int bn, cudaStream_t st) {
  if (bm == 32 && bn == 32) return launch_mma<T, 1, 2, 1>(p, st);
  if (bm == 32 && bn == 64) return launch_mma<T, 1, 2, 2>(p, st);
  if (bm == 64 && bn == 128) return launch_mma<T, 2, 2, 4>(p, st);
  if (bm == 128 && bn == 128) return launch_mma<T, 4, 2, 4>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x_bf16: 1 for bfloat16 x, 0 for float32. is_signed: int8 weights (1) or
// uint8 (0, flipped into int8 at load; wsum and w_zp describe the flipped
// codes). x_shift: 128 for uint8 input codes, 0 for int8. bias may be null.
// The launch plan (ops/kernels/matmul_q8.py::q8_plan): route 1 is the mma
// route (N % 16 == 0, w 16-byte aligned, K < 2^17), 0 the simt route; bm, bn
// the block tile; split_slices the 32-row slices of K a block walks (mma
// route; the grid has ceil(K / 32 / split_slices) blocks along K). ws holds
// splits * tiles * bm * bn int32 and counters one zeroed uint32 a tile when
// the plan splits K; both may be null otherwise. Returns cudaGetLastError()
// after the launch.
extern "C" int oqt_q8_matmul(const void* x, int x_bf16, const void* w, const void* wsum,
                             const void* wzp, const void* req, const void* bias,
                             const void* fparams, const void* iparams, void* out, int M, int K,
                             int N, int is_signed, int x_shift, int iqmin, int iqmax, int oqmin,
                             int oqmax, int route, int bm, int bn, int split_slices, void* ws,
                             void* counters, void* stream) {
  const int x_bytes = x_bf16 ? 2 : 4;
  const Q8Args p{x,
                 static_cast<const uint8_t*>(w),
                 static_cast<const int*>(wsum),
                 static_cast<const int*>(wzp),
                 static_cast<const float*>(req),
                 static_cast<const int*>(bias),
                 static_cast<const float*>(fparams),
                 static_cast<const int*>(iparams),
                 static_cast<float*>(out),
                 static_cast<int*>(ws),
                 static_cast<unsigned int*>(counters),
                 M,
                 K,
                 N,
                 is_signed ? 0u : 0x80808080u,
                 x_shift,
                 iqmin,
                 iqmax,
                 oqmin,
                 oqmax,
                 split_slices,
                 reinterpret_cast<uintptr_t>(x) % 16 == 0 && (K * x_bytes) % 16 == 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (N % 16 != 0 || split_slices <= 0 || K >= (1 << 17))
      return static_cast<int>(cudaErrorInvalidValue);
    if (reinterpret_cast<uintptr_t>(w) % 16 != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
    if ((K + kSliceK - 1) / kSliceK > split_slices && (ws == nullptr || counters == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    return x_bf16 ? dispatch_mma<__nv_bfloat16>(p, bm, bn, st) : dispatch_mma<float>(p, bm, bn, st);
  }
  return x_bf16 ? dispatch_simt<__nv_bfloat16>(p, bm, bn, st) : dispatch_simt<float>(p, bm, bn, st);
}
