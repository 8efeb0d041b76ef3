// W4 group-pair dequant-matmul for Hopper (sm_90a).
//
// Replaces the Pallas kernel onnx_quantize_tpu/ops/kernels/matmul_w4.py
// (_w4_call -> _w4_kernel). Computes out = x @ dequant(W) in float32 for
// 4-bit weights in the group-pair nibble layout: packed row p*gs + r holds
// logical row (2p)*gs + r in its low nibble (scale group 2p) and
// (2p+1)*gs + r in its high nibble (group 2p+1). The dequant affine is applied
// to each group's partial dot, not to the weights:
//     x . ((w - zp) * s) == (x . w - sum(x) * zp) * s.
//
// Shapes: x (M, K_pad) bfloat16 or float32, K_pad = 2 * half_rows;
// w (half_rows, N) uint8; scale and zp (G_pad/2, 2, N) float32, with pad
// groups carrying (1, 0); out (M, N) float32.
//
// What bounds it on the card: at decode (M <= 64) the packed weight bytes
// (a Gemma-3-270M layer's four sites read 3.1 MB, ~1 us at 3.35 TB/s); at
// M >= 2048 the operations (2 * M * K * N bf16, 26 GFLOP a layer at
// M = 2048, ~26 us at 989 TFLOP/s). Two routes, chosen by the launch plan
// (ops/kernels/matmul_w4.py::w4_plan):
//
// mma (bf16 x, group size and N multiples of 16, 16-byte-aligned x and w):
//   tensor cores.
//   - mma.sync m16n8k16 bf16 -> f32. A nibble is exact in bf16: 0x4300 | nib
//     read as bf16 is 128 + nib (int4: nib ^ 8 is value + 8, so 136), and
//     one bf16x2 fma by 1 subtracts the offset exactly. prmt + lop3 build the
//     operand registers; no integer-to-float conversion.
//   - Each 16-row slice of packed rows feeds two mmas: its low nibbles
//     against x[:, 2p*gs + r ...] and its high nibbles against
//     x[:, (2p+1)*gs + r ...], into two group-partial accumulators. A third
//     and fourth mma against a B of ones give sum(x) over the same columns in
//     float32 from the staged x tile, so the fold needs no other pass over x.
//     When the pair changes (or the block's K range ends) the partials fold
//     into the output accumulator element-wise on the C fragment:
//     acc += (d - xsum[m] * zp[n]) * s[n].
//   - x and weight tiles go through shared memory with 16-byte cp.async in a
//     ring of three stages (four slices a stage); x fragments come by
//     ldmatrix, weight fragments as four 32-bit words a lane (rows k, k+1,
//     k+8, k+9 of four adjacent columns; the row pitch is padded so the
//     words of a warp fall in 32 distinct banks). Lane g of the warp feeds
//     column 4g + j of n-tile j, which the fold and the epilogue follow.
//   - The affine is linear, so a chunk of 16 packed rows inside a group can
//     carry its own partial xsum: K splits at 16-row granularity. At decode
//     the plan splits K until the grid has at least one block per SM (the
//     N = 640 sites of a Gemma-3-270M layer launch 160 blocks, not 20).
//     Each split block writes its partial tile to scratch, fences and counts
//     itself on the tile's counter; the last to arrive sums the partials in
//     split order (fixed, so two launches give the same bits), writes out
//     and sets the counter back to 0, which keeps the launch replayable in a
//     CUDA graph. One launch: no memset, no second pass, no float atomics.
//   - Large M takes 64 x 128 tiles and no split: there are enough tiles.
//
// simt (float32 x, or any other shape or alignment): the CUDA-core kernel of
//   the first port. A bf16 mma cannot hold a float32 x
//   exactly; the main path runs bf16. One block covers 32 * CPT columns and
//   BM rows and walks every group pair with float32 FMAs.

#include "common.cuh"

namespace {

using oqt::kRowChunk;
using oqt::kThreadsM;
using oqt::kThreadsN;

// ---- simt route ---------------------------------------------------------------

template <typename T, int RPT, int CPT>
__global__ void __launch_bounds__(oqt::kThreads)
w4_kernel(const T* __restrict__ x, const uint8_t* __restrict__ w,
          const float* __restrict__ scale, const float* __restrict__ zp,
          float* __restrict__ out, int M, int K_pad, int N, int gs, int sign_off) {
  constexpr int BM = RPT * kThreadsM;
  __shared__ float xs[2][BM][kRowChunk];
  __shared__ float xsum[2][BM];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kThreadsN + tx;
  const int col0 = (blockIdx.x * kThreadsN + tx) * CPT;
  const int m0 = blockIdx.y * BM;
  const bool col_ok = col0 < N;  // CPT == 4 only when N % 4 == 0
  const int n_pairs = K_pad / (2 * gs);

  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  for (int p = 0; p < n_pairs; ++p) {
    float dlo[RPT][CPT], dhi[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) dlo[i][c] = dhi[i][c] = 0.f;

    __syncthreads();  // the previous pair's epilogue has read xsum
    if (tid < 2 * BM) xsum[tid / BM][tid % BM] = 0.f;

    for (int r0 = 0; r0 < gs; r0 += kRowChunk) {
      const int rc = min(kRowChunk, gs - r0);
      __syncthreads();  // the previous chunk is consumed
      oqt::stage_rows<T, BM>(xs[0], x, M, K_pad, m0, (2 * p) * gs + r0, rc, tid);
      oqt::stage_rows<T, BM>(xs[1], x, M, K_pad, m0, (2 * p + 1) * gs + r0, rc, tid);
      __syncthreads();
      if (tid < 2 * BM) {
        const int h = tid / BM, m = tid % BM;
        float s = 0.f;
        for (int r = 0; r < rc; ++r) s += xs[h][m][r];
        xsum[h][m] += s;
      }
      if (col_ok) {
        const uint8_t* wrow = w + static_cast<size_t>(p * gs + r0) * N + col0;
        for (int r = 0; r < rc; ++r, wrow += N) {
          const uint32_t bytes = oqt::load_bytes<CPT>(wrow);
          float lo[CPT], hi[CPT];
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            const int b = (bytes >> (8 * c)) & 0xFF;
            // sign_off is 8 for int4 (sign-extend the nibble), 0 for uint4.
            lo[c] = static_cast<float>(((b & 0x0F) ^ sign_off) - sign_off);
            hi[c] = static_cast<float>(((b >> 4) ^ sign_off) - sign_off);
          }
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const float xl = xs[0][ty + i * kThreadsM][r];
            const float xh = xs[1][ty + i * kThreadsM][r];
#pragma unroll
            for (int c = 0; c < CPT; ++c) {
              dlo[i][c] = fmaf(xl, lo[c], dlo[i][c]);
              dhi[i][c] = fmaf(xh, hi[c], dhi[i][c]);
            }
          }
        }
      }
    }
    __syncthreads();  // xsum is complete
    if (col_ok) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const size_t lo_row = static_cast<size_t>(2 * p) * N + col0 + c;
        const float s_lo = scale[lo_row], z_lo = zp[lo_row];
        const float s_hi = scale[lo_row + N], z_hi = zp[lo_row + N];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int m = ty + i * kThreadsM;
          acc[i][c] += (dlo[i][c] - xsum[0][m] * z_lo) * s_lo +
                       (dhi[i][c] - xsum[1][m] * z_hi) * s_hi;
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

template <typename T, int RPT, int CPT>
void launch_simt(const void* x, const void* w, const void* s, const void* z, void* out, int M,
                 int K_pad, int N, int gs, int sign_off, cudaStream_t stream) {
  constexpr int BM = RPT * kThreadsM;
  const dim3 grid((N + kThreadsN * CPT - 1) / (kThreadsN * CPT), (M + BM - 1) / BM);
  const dim3 block(kThreadsN, kThreadsM);
  w4_kernel<T, RPT, CPT><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(w), static_cast<const float*>(s),
      static_cast<const float*>(z), static_cast<float*>(out), M, K_pad, N, gs, sign_off);
}

// bm: 32 or 64 rows a block; bn: 32 (one column a thread) or 128 (four).
template <typename T>
void dispatch_simt(const void* x, const void* w, const void* s, const void* z, void* out, int M,
                   int K_pad, int N, int gs, int sign_off, int bm, int bn, cudaStream_t stream) {
  if (bm <= 32) {
    if (bn == 128) launch_simt<T, 4, 4>(x, w, s, z, out, M, K_pad, N, gs, sign_off, stream);
    else launch_simt<T, 4, 1>(x, w, s, z, out, M, K_pad, N, gs, sign_off, stream);
  } else {
    if (bn == 128) launch_simt<T, 8, 4>(x, w, s, z, out, M, K_pad, N, gs, sign_off, stream);
    else launch_simt<T, 8, 1>(x, w, s, z, out, M, K_pad, N, gs, sign_off, stream);
  }
}

// ---- mma route ----------------------------------------------------------------

constexpr int kSlice = 16;   // packed rows a slice: the mma's K
constexpr int kKS = 4;       // slices a pipeline stage
constexpr int kStages = 3;   // cp.async ring depth

// A block of WARPS_M x WARPS_N warps; a warp owns WM m-tiles of 16 rows and
// 32 columns (four n-tiles of 8).
template <int WM, int WARPS_M, int WARPS_N>
struct MmaTile {
  static constexpr int kBM = WM * 16 * WARPS_M;
  static constexpr int kBN = 32 * WARPS_N;
  static constexpr int kThreads = 32 * WARPS_M * WARPS_N;
  // Staged weight rows: kBN bytes padded to a pitch of 4 (mod 16) words, so
  // rows 2t (t = 0..3) start 8 banks apart.
  static constexpr int kWPitch = kBN + 16;
  // Staged x rows, in bf16: kKS slices of (low 16, high 16) columns, padded
  // by 16 bytes so ldmatrix's eight rows fall in distinct bank groups.
  static constexpr int kXPitch = kKS * 32 + 8;
  static constexpr int kWBytes = kKS * kSlice * kWPitch;
  static constexpr int kXBytes = kBM * kXPitch * 2;
  static constexpr int kStageBytes = kWBytes + kXBytes;
  static constexpr int kOPitch = kBN + 4;  // floats a row of the epilogue tile
  static constexpr int kPipeBytes = kStages * kStageBytes;
  static constexpr int kOutBytes = kBM * kOPitch * 4;
  static constexpr int kSmem = kPipeBytes > kOutBytes ? kPipeBytes : kOutBytes;
};

using oqt::cp_async16;
using oqt::cp_async_commit;
using oqt::cp_async_wait;
using oqt::ldmatrix_x4;
using oqt::mma_bf16;

using oqt::bf16x2_fma;

constexpr uint32_t kOnes = oqt::kBf16x2Ones;

// Byte j of the words a (row k) and b (row k + 1) of a column, as two bf16x2
// registers (row k in the low half): the low nibbles and the high nibbles,
// each exact. nib_bits is 0x43004300 (uint4) or 0x43084308 (int4: nib ^ 8);
// neg_off is bf16x2 (-128, -128) or (-136, -136).
__device__ __forceinline__ void nibble_pairs(uint32_t a, uint32_t b, uint32_t sel,
                                             uint32_t nib_bits, uint32_t neg_off, uint32_t& lo,
                                             uint32_t& hi) {
  const uint32_t p = __byte_perm(a, b, sel);  // a.j a.j b.j b.j
  lo = bf16x2_fma((p & 0x000F000Fu) ^ nib_bits, kOnes, neg_off);
  hi = bf16x2_fma(((p >> 12) & 0x000F000Fu) ^ nib_bits, kOnes, neg_off);
}

// Stage s of the block's K range [c_begin, c_end) (in slices) into ring slot
// s % kStages: weight rows and the x columns of both nibble halves.
template <class Tl>
__device__ __forceinline__ void load_stage(uint8_t* smem, int s, const uint16_t* __restrict__ x,
                                           const uint8_t* __restrict__ w, int M, int K_pad, int N,
                                           int gs, int m0, int n0, int c_begin, int c_end,
                                           int tid) {
  uint8_t* wbuf = smem + (s % kStages) * Tl::kStageBytes;
  uint16_t* xbuf = reinterpret_cast<uint16_t*>(wbuf + Tl::kWBytes);
  const int c0 = c_begin + s * kKS;
  const int ns = min(kKS, c_end - c0);
  const int row0 = c0 * kSlice;
  constexpr int kRowChunks = Tl::kBN / 16;
  for (int i = tid; i < ns * kSlice * kRowChunks; i += Tl::kThreads) {
    const int r = i / kRowChunks, ch = i % kRowChunks;
    const int col = n0 + ch * 16;
    const bool ok = col < N;  // N % 16 == 0: a chunk is all in or all out
    cp_async16(wbuf + r * Tl::kWPitch + ch * 16,
               ok ? w + static_cast<size_t>(row0 + r) * N + col : w, ok);
  }
  const int per_row = ns * 4;  // slices x (low, high) x two 8-column chunks
  for (int i = tid; i < Tl::kBM * per_row; i += Tl::kThreads) {
    const int m = i / per_row, rem = i % per_row;
    const int sl = rem >> 2, h = (rem >> 1) & 1, q = rem & 1;
    const int prow = (c0 + sl) * kSlice;
    const int col = (2 * (prow / gs) + h) * gs + prow % gs + q * 8;
    const bool ok = m0 + m < M;
    cp_async16(xbuf + m * Tl::kXPitch + sl * 32 + h * 16 + q * 8,
               ok ? x + static_cast<size_t>(m0 + m) * K_pad + col : x, ok);
  }
}

template <int WM, int WARPS_M, int WARPS_N>
__global__ void __launch_bounds__(32 * WARPS_M * WARPS_N)
w4_mma_kernel(const uint16_t* __restrict__ x, const uint8_t* __restrict__ w,
              const float* __restrict__ scale, const float* __restrict__ zp,
              float* __restrict__ out, float* __restrict__ ws, unsigned int* __restrict__ counters,
              int M, int K_pad, int N, int gs, int is_signed, int split_chunks) {
  using Tl = MmaTile<WM, WARPS_M, WARPS_N>;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ unsigned int s_last;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp / WARPS_N, warp_n = warp % WARPS_N;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * Tl::kBN, m0 = blockIdx.y * Tl::kBM;
  const int chunks = K_pad / (2 * kSlice);
  const int c_begin = blockIdx.z * split_chunks;
  const int c_end = min(chunks, c_begin + split_chunks);
  const int n_stages = (c_end - c_begin + kKS - 1) / kKS;
  const uint32_t nib_bits = is_signed ? 0x43084308u : 0x43004300u;
  const uint32_t neg_off = is_signed ? 0xC308C308u : 0xC300C300u;  // -136 or -128

  float acc[WM][4][4], dlo[WM][4][4], dhi[WM][4][4], xlo[WM][4], xhi[WM][4];
#pragma unroll
  for (int mt = 0; mt < WM; ++mt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      xlo[mt][e] = xhi[mt][e] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][j][e] = dlo[mt][j][e] = dhi[mt][j][e] = 0.f;
    }
  }
  // The current pair's scale and zero point, low and high group, for the two
  // columns (q = 0, 1) of each n-tile j this lane's C fragment holds:
  // column n0 + warp_n * 32 + 4 * (2t + q) + j.
  float sz[4][2][4];
  int cur_p = (c_begin * kSlice) / gs;

  auto load_scales = [&](int p) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int n = n0 + warp_n * 32 + 4 * (2 * t + q) + j;
        const size_t lo = static_cast<size_t>(2 * p) * N + n;
        const bool ok = n < N;
        sz[j][q][0] = ok ? scale[lo] : 0.f;
        sz[j][q][1] = ok ? zp[lo] : 0.f;
        sz[j][q][2] = ok ? scale[lo + N] : 0.f;
        sz[j][q][3] = ok ? zp[lo + N] : 0.f;
      }
  };
  // acc += (d - xsum * zp) * s for both groups of the pair; the partials
  // restart. xsum of row g is C element 0 of the ones-mma, of row g + 8
  // element 2.
  auto fold = [&]() {
#pragma unroll
    for (int mt = 0; mt < WM; ++mt) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = e & 1;
          acc[mt][j][e] += (dlo[mt][j][e] - xlo[mt][e & 2] * sz[j][q][1]) * sz[j][q][0] +
                           (dhi[mt][j][e] - xhi[mt][e & 2] * sz[j][q][3]) * sz[j][q][2];
          dlo[mt][j][e] = dhi[mt][j][e] = 0.f;
        }
#pragma unroll
      for (int e = 0; e < 4; ++e) xlo[mt][e] = xhi[mt][e] = 0.f;
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_stages)
      load_stage<Tl>(smem, s, x, w, M, K_pad, N, gs, m0, n0, c_begin, c_end, tid);
    cp_async_commit();
  }
  // The first pair's scales load while the first stages are in flight.
  load_scales(cur_p);
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage s landed; every warp is done with stage s - 1
    if (s + kStages - 1 < n_stages)
      load_stage<Tl>(smem, s + kStages - 1, x, w, M, K_pad, N, gs, m0, n0, c_begin, c_end, tid);
    cp_async_commit();

    const uint8_t* wbuf = smem + (s % kStages) * Tl::kStageBytes;
    const uint16_t* xbuf = reinterpret_cast<const uint16_t*>(wbuf + Tl::kWBytes);
    const int c0 = c_begin + s * kKS;
    const int ns = min(kKS, c_end - c0);
    for (int sl = 0; sl < ns; ++sl) {
      const int p = ((c0 + sl) * kSlice) / gs;
      if (p != cur_p) {
        fold();
        cur_p = p;
        load_scales(p);
      }
      uint32_t alo[WM][4], ahi[WM][4];
#pragma unroll
      for (int mt = 0; mt < WM; ++mt) {
        const uint16_t* a = xbuf + ((warp_m * WM + mt) * 16 + (lane & 15)) * Tl::kXPitch +
                            sl * 32 + (lane >> 4) * 8;
        ldmatrix_x4(alo[mt], a);
        ldmatrix_x4(ahi[mt], a + 16);
      }
      const uint8_t* wrow = wbuf + (sl * kSlice + 2 * t) * Tl::kWPitch + warp_n * 32 + 4 * g;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(wrow);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(wrow + Tl::kWPitch);
      const uint32_t w8 = *reinterpret_cast<const uint32_t*>(wrow + 8 * Tl::kWPitch);
      const uint32_t w9 = *reinterpret_cast<const uint32_t*>(wrow + 9 * Tl::kWPitch);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t sel = j | (j << 4) | ((j + 4) << 8) | ((j + 4) << 12);
        uint32_t lo0, hi0, lo1, hi1;
        nibble_pairs(w0, w1, sel, nib_bits, neg_off, lo0, hi0);
        nibble_pairs(w8, w9, sel, nib_bits, neg_off, lo1, hi1);
#pragma unroll
        for (int mt = 0; mt < WM; ++mt) {
          mma_bf16(dlo[mt][j], alo[mt], lo0, lo1);
          mma_bf16(dhi[mt][j], ahi[mt], hi0, hi1);
        }
      }
#pragma unroll
      for (int mt = 0; mt < WM; ++mt) {
        mma_bf16(xlo[mt], alo[mt], kOnes, kOnes);
        mma_bf16(xhi[mt], ahi[mt], kOnes, kOnes);
      }
    }
  }
  cp_async_wait<0>();
  fold();
  __syncthreads();  // every warp is done with the ring; it becomes the out tile

  float* tile = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mt = 0; mt < WM; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = (warp_m * WM + mt) * 16 + g + 8 * (e >> 1);
        const int c = warp_n * 32 + 4 * (2 * t + (e & 1)) + j;
        tile[r * Tl::kOPitch + c] = acc[mt][j][e];
      }
  __syncthreads();

  constexpr int kTileElems = Tl::kBM * Tl::kBN;
  const int splits = gridDim.z;
  if (splits == 1) {
    for (int i = tid; i < kTileElems; i += Tl::kThreads) {
      const int r = i / Tl::kBN, c = i % Tl::kBN;
      if (m0 + r < M && n0 + c < N)
        out[static_cast<size_t>(m0 + r) * N + n0 + c] = tile[r * Tl::kOPitch + c];
    }
    return;
  }

  // K split: this block's partial tile to scratch; the last block of the
  // tile to arrive sums all partials in split order.
  const int tile_id = blockIdx.y * gridDim.x + blockIdx.x;
  float* parts = ws + static_cast<size_t>(tile_id) * splits * kTileElems;
  float4* mine = reinterpret_cast<float4*>(parts + static_cast<size_t>(blockIdx.z) * kTileElems);
  for (int i = tid; i < kTileElems / 4; i += Tl::kThreads) {
    const int r = (4 * i) / Tl::kBN, c = (4 * i) % Tl::kBN;
    const float* src = tile + r * Tl::kOPitch + c;
    mine[i] = make_float4(src[0], src[1], src[2], src[3]);
  }
  __threadfence();  // the partial is visible device-wide before the count
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(counters + tile_id, 1u) == static_cast<unsigned>(splits - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const float4* all = reinterpret_cast<const float4*>(parts);
  for (int i = tid; i < kTileElems / 4; i += Tl::kThreads) {
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int z = 0; z < splits; ++z) {
      const float4 v = __ldcg(all + static_cast<size_t>(z) * (kTileElems / 4) + i);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    const int r = (4 * i) / Tl::kBN, c = (4 * i) % Tl::kBN;
    if (m0 + r >= M) continue;
    float* dst = out + static_cast<size_t>(m0 + r) * N + n0 + c;
    const float vals[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (n0 + c + k < N) dst[k] = vals[k];
  }
  if (tid == 0) counters[tile_id] = 0u;  // ready for the next launch (or graph replay)
}

template <int WM, int WARPS_M, int WARPS_N>
int launch_mma(const void* x, const void* w, const void* s, const void* z, void* out, void* ws,
               void* counters, int M, int K_pad, int N, int gs, int is_signed, int split_chunks,
               cudaStream_t stream) {
  using Tl = MmaTile<WM, WARPS_M, WARPS_N>;
  auto kernel = w4_mma_kernel<WM, WARPS_M, WARPS_N>;
  if (Tl::kSmem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int chunks = K_pad / (2 * kSlice);
  const int splits = (chunks + split_chunks - 1) / split_chunks;
  const dim3 grid((N + Tl::kBN - 1) / Tl::kBN, (M + Tl::kBM - 1) / Tl::kBM, splits);
  kernel<<<grid, Tl::kThreads, Tl::kSmem, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint8_t*>(w),
      static_cast<const float*>(s), static_cast<const float*>(z), static_cast<float*>(out),
      static_cast<float*>(ws), static_cast<unsigned int*>(counters), M, K_pad, N, gs, is_signed,
      split_chunks);
  return static_cast<int>(cudaGetLastError());
}

// The tile of the plan: bm 16, 32 or 64 with bn 64, or bm 64 with bn 128.
int dispatch_mma(const void* x, const void* w, const void* s, const void* z, void* out, void* ws,
                 void* counters, int M, int K_pad, int N, int gs, int is_signed, int bm, int bn,
                 int split_chunks, cudaStream_t st) {
  if (bn == 128)
    return launch_mma<2, 2, 4>(x, w, s, z, out, ws, counters, M, K_pad, N, gs, is_signed,
                               split_chunks, st);
  if (bm == 16)
    return launch_mma<1, 1, 2>(x, w, s, z, out, ws, counters, M, K_pad, N, gs, is_signed,
                               split_chunks, st);
  if (bm == 32)
    return launch_mma<1, 2, 2>(x, w, s, z, out, ws, counters, M, K_pad, N, gs, is_signed,
                               split_chunks, st);
  return launch_mma<2, 2, 2>(x, w, s, z, out, ws, counters, M, K_pad, N, gs, is_signed,
                             split_chunks, st);
}

}  // namespace

// x_bf16: 1 for bfloat16 x, 0 for float32. is_signed: int4 (1) or uint4 (0).
// The launch plan (ops/kernels/matmul_w4.py::w4_plan): route 1 is the mma
// route (bf16 x, gs % 16 == 0, N % 16 == 0, x and w 16-byte aligned), 0 the
// simt route; bm, bn the block tile;
// split_chunks the 16-row slices of packed rows a block walks (mma route;
// the grid has ceil(K_pad / 32 / split_chunks) blocks along K). ws holds
// splits * tiles * bm * bn floats and counters one zeroed uint32 a tile when
// the plan splits K; both may be null otherwise.
// Returns cudaGetLastError() after the launch.
extern "C" int oqt_w4_matmul(const void* x, int x_bf16, const void* w, const void* scale,
                             const void* zp, void* out, int M, int K_pad, int N, int gs,
                             int is_signed, int route, int bm, int bn, int split_chunks, void* ws,
                             void* counters, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (!x_bf16 || gs % kSlice != 0 || N % 16 != 0 || split_chunks <= 0)
      return static_cast<int>(cudaErrorInvalidValue);
    if (reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
    return dispatch_mma(x, w, scale, zp, out, ws, counters, M, K_pad, N, gs, is_signed, bm, bn,
                        split_chunks, st);
  }
  const int sign_off = is_signed ? 8 : 0;
  if (x_bf16) {
    dispatch_simt<__nv_bfloat16>(x, w, scale, zp, out, M, K_pad, N, gs, sign_off, bm, bn, st);
  } else {
    dispatch_simt<float>(x, w, scale, zp, out, M, K_pad, N, gs, sign_off, bm, bn, st);
  }
  return static_cast<int>(cudaGetLastError());
}
