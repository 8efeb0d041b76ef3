// W8 dequant-matmul for Hopper (sm_90a).
//
// Replaces the Pallas kernel onnx_quantize_tpu/ops/kernels/matmul_w8.py
// (_w8_call -> _w8_kernel). Computes out = x @ dequant(W) in float32 for
// int8/uint8 weights with one scale row per K tile of bk rows (a tensor or
// channel scale is one tile spanning K; a group scale has bk = group size).
// The affine goes on each tile's partial dot:
//     x . ((w - zp) * s) == (x . w - sum(x) * zp) * s,
// and the symmetric path (zero point 0) skips the zp term.
//
// Shapes: x (M, K) float32 or bfloat16; w (K, N) int8/uint8; scale and zp
// (K / bk, N) float32 (zp unused when symmetric); out (M, N) float32.
//
// What bounds it on the card: the Gemma-3-270M lm_head (K = 640, N = 262144)
// reads 168 MB of weights at decode (M = 32, ~60 us at 3.35 TB/s with the
// 33.5 MB of float32 logits); over a 2048-token scoring window it does
// 0.69 TFLOP of bf16 products (~0.69 ms at 989 TFLOP/s) and writes 2.15 GB of
// float32 logits (~0.64 ms). Two routes, chosen by the launch plan
// (ops/kernels/matmul_w8.py::w8_plan):
//
// mma (bf16 x, bk and N multiples of 16, 16-byte-aligned x and w): tensor
//   cores, on the skeleton of W4's mma route.
//   - mma.sync m16n8k16 bf16 -> f32. Every int8 and uint8 value is exact in
//     bf16 (at most 8 significant bits). A byte becomes one: prmt puts it
//     under the exponent bits of 2^23 (0x4B0000bb is the float 2^23 + b),
//     one float subtraction of the magic leaves b (int8 bytes are XORed with
//     0x80 first and lose 2^23 + 128), and cvt.rn.bf16x2.f32 packs two rows.
//     No integer-to-float conversion. (Two nibbles through W4's bf16 trick
//     took 10% longer at M = 32, exploration on the card.)
//   - x and weight rows go through shared memory by 16-byte cp.async in a
//     ring of three stages of 64 K rows; x fragments come by ldmatrix, weight
//     fragments as four 32-bit words a lane (rows k, k + 1, k + 8, k + 9 of
//     four adjacent columns; lane g feeds column 4g + j of n-tile j), so a
//     lane's C fragments hold 8 adjacent columns and the epilogue stores them
//     as two float4s from registers.
//   - sum(x) for the zero point comes from an mma of the staged x against a
//     B of ones (skipped on the symmetric path). At each K-tile change the
//     tile's partials fold into the output accumulator on the C fragment:
//     acc += (d - xsum * zp) * s. A single tile (channel or tensor scale)
//     folds once, at the end.
//   - Tiles: 16, 32 or 64 rows by 128 columns (the lm_head launches 2,048
//     blocks at M = 32), M tiles fastest in the grid. A block has four warps
//     side by side along N, each owning all the block's rows, so each weight
//     byte is converted once a block: with two warps along M (W4's layout)
//     the lm_head took 39% longer at M = 32 and 46% at M = 2048 (exploration
//     on the card). Where the tiles number fewer than the SMs the plan
//     splits K in 16-row slices (each split folds its own partial sums, the
//     affine being linear); the last block of a tile sums the partial tiles
//     in split order (fence, counter, __ldcg, counter back to 0: one launch,
//     replayable in a CUDA graph), as W4 does.
//   - Large M with a single K tile (the lm_head over a scoring window): the
//     x-stationary form. Staging x with every 128 x 128 tile reads 8 GB from
//     L2 at M = 2048, and with the mma or the conversion cut out that kernel
//     took nearly as long, so the loads bound it. Instead one block an SM
//     keeps a 128-row x tile (64 where K is too long) of all of K resident in
//     shared memory and walks a contiguous range of 256-column output tiles,
//     M-tile major: only the weights stream through the ring, which runs on
//     across tiles, and x is loaded again only where the range enters the
//     next M tile (3.81 -> 3.08 ms at the lm_head's M = 2048; exploration on
//     the card, where no single phase bound it any more).
//
// simt (float32 x, or any other shape or alignment): the CUDA-core kernel of
//   the first port. One block covers 32 * CPT columns and BM rows (the block
//   shape of common.cuh) and walks all of K with float32 FMAs.

#include "common.cuh"

namespace {

using oqt::cp_async16;
using oqt::cp_async_commit;
using oqt::cp_async_wait;
using oqt::kRowChunk;
using oqt::kThreadsM;
using oqt::kThreadsN;
using oqt::ldmatrix_x4;
using oqt::mma_bf16;

constexpr uint32_t kOnes = oqt::kBf16x2Ones;

// ---- simt route ---------------------------------------------------------------

template <typename T, int RPT, int CPT>
__global__ void __launch_bounds__(oqt::kThreads)
w8_kernel(const T* __restrict__ x, const uint8_t* __restrict__ w,
          const float* __restrict__ scale, const float* __restrict__ zp,
          float* __restrict__ out, int M, int K, int N, int bk, int sign_off, int symmetric) {
  constexpr int BM = RPT * kThreadsM;
  __shared__ float xs[BM][kRowChunk];
  __shared__ float xsum[BM];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kThreadsN + tx;
  const int col0 = (blockIdx.x * kThreadsN + tx) * CPT;
  const int m0 = blockIdx.y * BM;
  const bool col_ok = col0 < N;  // CPT == 4 only when N % 4 == 0
  const int n_tiles = K / bk;

  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    float d[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) d[i][c] = 0.f;

    __syncthreads();  // the previous tile's epilogue has read xsum
    if (tid < BM) xsum[tid] = 0.f;

    for (int r0 = 0; r0 < bk; r0 += kRowChunk) {
      const int rc = min(kRowChunk, bk - r0);
      __syncthreads();  // the previous chunk is consumed
      oqt::stage_rows<T, BM>(xs, x, M, K, m0, t * bk + r0, rc, tid);
      __syncthreads();
      if (!symmetric && tid < BM) {
        float s = 0.f;
        for (int r = 0; r < rc; ++r) s += xs[tid][r];
        xsum[tid] += s;
      }
      if (col_ok) {
        const uint8_t* wrow = w + static_cast<size_t>(t * bk + r0) * N + col0;
        for (int r = 0; r < rc; ++r, wrow += N) {
          const uint32_t bytes = oqt::load_bytes<CPT>(wrow);
          float wv[CPT];
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            // sign_off is 128 for int8 (sign-extend the byte), 0 for uint8.
            const int b = static_cast<int>((bytes >> (8 * c)) & 0xFF);
            wv[c] = static_cast<float>((b ^ sign_off) - sign_off);
          }
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const float xv = xs[ty + i * kThreadsM][r];
#pragma unroll
            for (int c = 0; c < CPT; ++c) d[i][c] = fmaf(xv, wv[c], d[i][c]);
          }
        }
      }
    }
    __syncthreads();  // xsum is complete
    if (col_ok) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const size_t row = static_cast<size_t>(t) * N + col0 + c;
        const float s = scale[row];
        const float z = symmetric ? 0.f : zp[row];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float part = symmetric ? d[i][c] : d[i][c] - xsum[ty + i * kThreadsM] * z;
          acc[i][c] += part * s;
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
                 int K, int N, int bk, int sign_off, int symmetric, cudaStream_t stream) {
  constexpr int BM = RPT * kThreadsM;
  const dim3 grid((N + kThreadsN * CPT - 1) / (kThreadsN * CPT), (M + BM - 1) / BM);
  const dim3 block(kThreadsN, kThreadsM);
  w8_kernel<T, RPT, CPT><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(w), static_cast<const float*>(s),
      static_cast<const float*>(z), static_cast<float*>(out), M, K, N, bk, sign_off, symmetric);
}

// bm: 32 or 64 rows a block; cols4: four columns a thread (N % 4 == 0).
template <typename T>
void dispatch_simt(const void* x, const void* w, const void* s, const void* z, void* out, int M,
                   int K, int N, int bk, int sign_off, int symmetric, int bm, bool cols4,
                   cudaStream_t stream) {
  if (bm <= 32) {
    if (cols4) launch_simt<T, 4, 4>(x, w, s, z, out, M, K, N, bk, sign_off, symmetric, stream);
    else launch_simt<T, 4, 1>(x, w, s, z, out, M, K, N, bk, sign_off, symmetric, stream);
  } else {
    if (cols4) launch_simt<T, 8, 4>(x, w, s, z, out, M, K, N, bk, sign_off, symmetric, stream);
    else launch_simt<T, 8, 1>(x, w, s, z, out, M, K, N, bk, sign_off, symmetric, stream);
  }
}

// ---- mma route ----------------------------------------------------------------

constexpr int kSlice = 16;   // K rows a slice: the mma's K

// A block of WARPS_M x WARPS_N warps; a warp owns WM m-tiles of 16 rows and
// 32 columns (four n-tiles of 8).
template <int WM, int WARPS_M, int WARPS_N>
struct MmaTile {
  static constexpr int kKS = 4;      // slices a pipeline stage
  static constexpr int kStages = 3;  // cp.async ring depth
  static constexpr int kBM = WM * 16 * WARPS_M;
  static constexpr int kBN = 32 * WARPS_N;
  static constexpr int kThreads = 32 * WARPS_M * WARPS_N;
  // Staged weight rows: kBN bytes padded to a pitch of 4 (mod 16) words, so
  // rows 2t (t = 0..3) start 8 banks apart.
  static constexpr int kWPitch = kBN + 16;
  // Staged x rows, in bf16: a stage's 64 columns padded by 16 bytes, so
  // ldmatrix's eight rows fall in distinct bank groups.
  static constexpr int kXPitch = kKS * kSlice + 8;
  static constexpr int kWBytes = kKS * kSlice * kWPitch;
  static constexpr int kXBytes = kBM * kXPitch * 2;
  static constexpr int kStageBytes = kWBytes + kXBytes;
  static constexpr int kSmem = kStages * kStageBytes;
};

// The operands of one call (kernel parameter space).
struct W8Args {
  const uint16_t* x;  // bf16 bits
  const uint8_t* w;
  const float* scale;
  const float* zp;         // null when symmetric
  float* out;
  float* ws;               // K split: partial tiles
  unsigned int* counters;  // K split: one counter a tile, 0 between launches
  int M, K, N;
  int tile_slices;   // 16-row slices of a K tile (bk / 16)
  int split_slices;  // 16-row slices of K a block walks
  uint32_t flip;     // 0x80808080 for int8 weights (to unsigned), else 0
  float magic;       // 2^23, and + 128 for int8 weights
};

// Byte j of the words a (row k) and b (row k + 1) of a column, as one bf16x2
// register, row k in the low half; bytes are unsigned (int8 flipped by the
// caller), magic removes 2^23 (and the flip's 128). Exact: 0x4B0000bb is the
// float 2^23 + b, the subtraction leaves a small integer, and a value of at
// most 8 significant bits converts to bf16 without rounding.
template <int J>
__device__ __forceinline__ uint32_t byte_pair(uint32_t a, uint32_t b, float magic) {
  constexpr uint32_t kSel = 0x7440u | J;  // byte J, 0x00, 0x00, 0x4B
  const float lo = __uint_as_float(__byte_perm(a, 0x4B000000u, kSel)) - magic;
  const float hi = __uint_as_float(__byte_perm(b, 0x4B000000u, kSel)) - magic;
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Stage s of the block's K range [c_begin, c_end) (in slices) into ring slot
// s % kStages: the weight rows and the x columns.
template <class Tl>
__device__ __forceinline__ void load_stage(uint8_t* smem, int s, const W8Args& p, int m0, int n0,
                                           int c_begin, int c_end, int tid) {
  uint8_t* wbuf = smem + (s % Tl::kStages) * Tl::kStageBytes;
  uint16_t* xbuf = reinterpret_cast<uint16_t*>(wbuf + Tl::kWBytes);
  const int c0 = c_begin + s * Tl::kKS;
  const int ns = min(Tl::kKS, c_end - c0);
  const int row0 = c0 * kSlice;
  constexpr int kRowChunks = Tl::kBN / 16;
  for (int i = tid; i < ns * kSlice * kRowChunks; i += Tl::kThreads) {
    const int r = i / kRowChunks, ch = i % kRowChunks;
    const int col = n0 + ch * 16;
    const bool ok = col < p.N;  // N % 16 == 0: a chunk is all in or all out
    cp_async16(wbuf + r * Tl::kWPitch + ch * 16,
               ok ? p.w + static_cast<size_t>(row0 + r) * p.N + col : p.w, ok);
  }
  // Two 8-column chunks a slice; the chunks of slices past the range are
  // skipped (a constant stride, so no division at run time).
  constexpr int kPerRow = Tl::kKS * 2;
#pragma unroll
  for (int i = tid; i < Tl::kBM * kPerRow; i += Tl::kThreads) {
    const int m = i / kPerRow, q = i % kPerRow;
    if (q >= 2 * ns) continue;
    const bool ok = m0 + m < p.M;
    cp_async16(xbuf + m * Tl::kXPitch + q * 8,
               ok ? p.x + static_cast<size_t>(m0 + m) * p.K + row0 + q * 8 : p.x, ok);
  }
}

// ONE_TILE: the K tile is all of K (a channel or tensor scale).
template <int WM, int WARPS_M, int WARPS_N, bool ONE_TILE>
__global__ void __launch_bounds__(32 * WARPS_M * WARPS_N) w8_mma_kernel(const W8Args p) {
  using Tl = MmaTile<WM, WARPS_M, WARPS_N>;
  constexpr int kKS = Tl::kKS, kStages = Tl::kStages;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ unsigned int s_last;

  const int N = p.N;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp / WARPS_N, warp_n = warp % WARPS_N;
  const int g = lane >> 2, t = lane & 3;
  // M tiles run fastest in the grid: the blocks in flight share few weight
  // columns, so each weight byte comes from device memory about once.
  const int m0 = blockIdx.x * Tl::kBM, n0 = blockIdx.y * Tl::kBN;
  const int c_begin = blockIdx.z * p.split_slices;
  const int c_end = min(p.K / kSlice, c_begin + p.split_slices);
  const int n_stages = (c_end - c_begin + kKS - 1) / kKS;
  const bool asym = p.zp != nullptr;
  // This lane's C columns col0 .. col0 + 7: element e of n-tile j is column
  // col0 + 4 (e & 1) + j (N % 16 == 0: all eight in or all out).
  const int col0 = n0 + warp_n * 32 + 8 * t;
  const bool col_ok = col0 < N;

  float acc[WM][4][4], d[WM][4][4], xs[WM][4];
#pragma unroll
  for (int mt = 0; mt < WM; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      xs[mt][e] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][j][e] = d[mt][j][e] = 0.f;
    }
  // The current K tile's scale and zero point for the lane's eight columns.
  float sc[8], zc[8];
  int cur = c_begin / p.tile_slices;
  auto load_scales = [&](int tile) {
    const size_t row = static_cast<size_t>(tile) * N + col0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      sc[i] = col_ok ? __ldg(p.scale + row + i) : 0.f;
      zc[i] = col_ok && asym ? __ldg(p.zp + row + i) : 0.f;
    }
  };
  // acc += (d - xsum * zp) * s; the partials restart. xsum of row g is C
  // element 0 of the ones-mma, of row g + 8 element 2.
  auto fold = [&]() {
#pragma unroll
    for (int mt = 0; mt < WM; ++mt) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * (e & 1) + j;
          acc[mt][j][e] += (d[mt][j][e] - xs[mt][e & 2] * zc[i]) * sc[i];
          d[mt][j][e] = 0.f;
        }
#pragma unroll
      for (int e = 0; e < 4; ++e) xs[mt][e] = 0.f;
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_stages) load_stage<Tl>(smem, s, p, m0, n0, c_begin, c_end, tid);
    cp_async_commit();
  }
  load_scales(cur);  // while the first stages are in flight
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage s landed; every warp is done with stage s - 1
    if (s + kStages - 1 < n_stages)
      load_stage<Tl>(smem, s + kStages - 1, p, m0, n0, c_begin, c_end, tid);
    cp_async_commit();

    const uint8_t* wbuf = smem + (s % kStages) * Tl::kStageBytes;
    const uint16_t* xbuf = reinterpret_cast<const uint16_t*>(wbuf + Tl::kWBytes);
    const int c0 = c_begin + s * kKS;
    const int ns = min(kKS, c_end - c0);
    for (int sl = 0; sl < ns; ++sl) {
      if constexpr (!ONE_TILE) {
        const int tile = (c0 + sl) / p.tile_slices;
        if (tile != cur) {
          fold();
          cur = tile;
          load_scales(tile);
        }
      }
      uint32_t a[WM][4];
#pragma unroll
      for (int mt = 0; mt < WM; ++mt)
        ldmatrix_x4(a[mt], xbuf + ((warp_m * WM + mt) * 16 + (lane & 15)) * Tl::kXPitch +
                               sl * kSlice + (lane >> 4) * 8);
      const uint8_t* wrow = wbuf + (sl * kSlice + 2 * t) * Tl::kWPitch + warp_n * 32 + 4 * g;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(wrow) ^ p.flip;
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(wrow + Tl::kWPitch) ^ p.flip;
      const uint32_t w8 = *reinterpret_cast<const uint32_t*>(wrow + 8 * Tl::kWPitch) ^ p.flip;
      const uint32_t w9 = *reinterpret_cast<const uint32_t*>(wrow + 9 * Tl::kWPitch) ^ p.flip;
      uint32_t b0[4], b1[4];
      b0[0] = byte_pair<0>(w0, w1, p.magic);
      b0[1] = byte_pair<1>(w0, w1, p.magic);
      b0[2] = byte_pair<2>(w0, w1, p.magic);
      b0[3] = byte_pair<3>(w0, w1, p.magic);
      b1[0] = byte_pair<0>(w8, w9, p.magic);
      b1[1] = byte_pair<1>(w8, w9, p.magic);
      b1[2] = byte_pair<2>(w8, w9, p.magic);
      b1[3] = byte_pair<3>(w8, w9, p.magic);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int mt = 0; mt < WM; ++mt) mma_bf16(d[mt][j], a[mt], b0[j], b1[j]);
      if (asym) {
#pragma unroll
        for (int mt = 0; mt < WM; ++mt) mma_bf16(xs[mt], a[mt], kOnes, kOnes);
      }
    }
  }
  cp_async_wait<0>();
  fold();

  const int splits = gridDim.z;
  if (splits > 1) {
    // K split: this block's partial tile to scratch (fragment order: float4
    // i of every thread, then i + 1); the last block of the tile to arrive
    // sums all partials in split order.
    constexpr int kTileVecs = Tl::kBM * Tl::kBN / 4;
    const int tile_id = blockIdx.y * gridDim.x + blockIdx.x;
    float4* parts =
        reinterpret_cast<float4*>(p.ws) + static_cast<size_t>(tile_id) * splits * kTileVecs;
    float4* mine = parts + static_cast<size_t>(blockIdx.z) * kTileVecs;
#pragma unroll
    for (int mt = 0; mt < WM; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mine[(mt * 4 + j) * Tl::kThreads + tid] =
            make_float4(acc[mt][j][0], acc[mt][j][1], acc[mt][j][2], acc[mt][j][3]);
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
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
#pragma unroll 2
    for (int z = 0; z < splits; ++z) {
      const float4* part = parts + static_cast<size_t>(z) * kTileVecs;
#pragma unroll
      for (int mt = 0; mt < WM; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 v = __ldcg(part + (mt * 4 + j) * Tl::kThreads + tid);
          acc[mt][j][0] += v.x;
          acc[mt][j][1] += v.y;
          acc[mt][j][2] += v.z;
          acc[mt][j][3] += v.w;
        }
    }
    if (tid == 0) p.counters[tile_id] = 0u;  // ready for the next launch (or graph replay)
  }
  if (!col_ok) return;
#pragma unroll
  for (int mt = 0; mt < WM; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + (warp_m * WM + mt) * 16 + g + 8 * h;
      if (m >= p.M) continue;
      float4* dst = reinterpret_cast<float4*>(p.out + static_cast<size_t>(m) * N + col0);
      dst[0] = make_float4(acc[mt][0][2 * h], acc[mt][1][2 * h], acc[mt][2][2 * h],
                           acc[mt][3][2 * h]);
      dst[1] = make_float4(acc[mt][0][2 * h + 1], acc[mt][1][2 * h + 1], acc[mt][2][2 * h + 1],
                           acc[mt][3][2 * h + 1]);
    }
}

template <int WM, int WARPS_M, int WARPS_N, bool ONE_TILE>
int launch_mma(const W8Args& p, cudaStream_t stream) {
  using Tl = MmaTile<WM, WARPS_M, WARPS_N>;
  auto kernel = w8_mma_kernel<WM, WARPS_M, WARPS_N, ONE_TILE>;
  if (Tl::kSmem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int slices = p.K / kSlice;
  const int splits = (slices + p.split_slices - 1) / p.split_slices;
  const dim3 grid((p.M + Tl::kBM - 1) / Tl::kBM, (p.N + Tl::kBN - 1) / Tl::kBN, splits);
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<grid, Tl::kThreads, Tl::kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---- the x-stationary form of the mma route (large M, one K tile) -------------

constexpr int kXsBN = 256;  // columns an output tile: eight warps of 32 along N
constexpr int kXsWPitch = kXsBN + 16;  // 68 words: rows 2t (t = 0..3) 8 banks apart
constexpr int kXsStageRows = 64;       // K rows a stage: four slices
constexpr int kXsStages = 3;
constexpr int kXsWBytes = kXsStageRows * kXsWPitch;

// Shared memory of the x-stationary kernel: the weight ring and a resident x
// tile of bm rows by all of K (a pitch of K + 8 bf16, an odd number of
// 16-byte chunks since K % 16 == 0, so ldmatrix's eight rows fall in
// distinct bank groups).
constexpr int xs_smem_bytes(int bm, int K) { return kXsStages * kXsWBytes + bm * (K + 8) * 2; }

// A block keeps an x tile of all of K resident in shared memory and walks a
// contiguous range of output tiles, M-tile major, so only the weights stream
// through the cp.async ring (which runs on across tiles) and x is loaded
// again only when the range crosses into the next M tile. Eight warps side
// by side along N each own 32 columns and, with WARPS_M == 1, all the block's
// rows, converting each weight byte once a block (two warps along M, each
// converting the same bytes, were 12% slower at the lm_head's shape). ZP:
// the asymmetric fold (sum(x) from the ones-mma).
template <int WM, int WARPS_M, bool ZP>
__global__ void __launch_bounds__(256 * WARPS_M, 1)
w8_mma_xs_kernel(const W8Args p, int per_block) {
  constexpr int kBM = WM * 16 * WARPS_M;
  constexpr int kXsThreads = 256 * WARPS_M;
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* xres = reinterpret_cast<uint16_t*>(smem + kXsStages * kXsWBytes);

  const int N = p.N, K = p.K, xpitch = p.K + 8;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = (tid >> 5) & 7, warp_m = tid >> 8;
  const int g = lane >> 2, t = lane & 3;
  const int n_tiles = (N + kXsBN - 1) / kXsBN;
  const int tiles = (p.M + kBM - 1) / kBM * n_tiles;
  const int first = blockIdx.x * per_block;
  const int my_tiles = min(tiles, first + per_block) - first;
  if (my_tiles <= 0) return;
  const int slices = K / kSlice;
  const int n_stages = (slices + 3) / 4;
  const int total = my_tiles * n_stages;

  // x rows [m0, m0 + kBM), all of K; rows past M are zero-filled.
  auto load_x = [&](int m0) {
    const int chunks = K / 8;
    for (int i = tid; i < kBM * chunks; i += kXsThreads) {
      const int r = i / chunks, c = i - r * chunks;
      const bool ok = m0 + r < p.M;
      cp_async16(xres + r * xpitch + c * 8,
                 ok ? p.x + static_cast<size_t>(m0 + r) * K + c * 8 : p.x, ok);
    }
  };
  // Stage q of the walk: K rows 64 (q % n_stages) .. of tile q / n_stages.
  auto load_w = [&](int q) {
    const int i = q / n_stages, st = q - i * n_stages;
    const int n0 = (first + i) % n_tiles * kXsBN;
    uint8_t* wbuf = smem + (q % kXsStages) * kXsWBytes;
    const int row0 = st * kXsStageRows;
    const int rows = min(kXsStageRows, K - row0);
    constexpr int kRowChunks = kXsBN / 16;
    for (int j = tid; j < rows * kRowChunks; j += kXsThreads) {
      const int r = j / kRowChunks, ch = j % kRowChunks;
      const int col = n0 + ch * 16;
      const bool ok = col < N;
      cp_async16(wbuf + r * kXsWPitch + ch * 16,
                 ok ? p.w + static_cast<size_t>(row0 + r) * N + col : p.w, ok);
    }
  };

  float d[WM][4][4], xs[ZP ? WM : 1][4];
  auto clear = [&]() {
#pragma unroll
    for (int mt = 0; mt < WM; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (ZP) xs[mt][e] = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) d[mt][j][e] = 0.f;
      }
  };
  clear();
  int m0 = first / n_tiles * kBM, col0 = 0;
  bool col_ok = false;
  float sc[8], zc[8];

  load_x(m0);
  cp_async_commit();
#pragma unroll
  for (int q = 0; q < kXsStages - 1; ++q) {
    if (q < total) load_w(q);
    cp_async_commit();
  }
  for (int q = 0; q < total; ++q) {
    const int i = q / n_stages, st = q - i * n_stages;
    if (st == 0) {
      const int tile = first + i;
      const int tm0 = tile / n_tiles * kBM;
      if (tm0 != m0) {  // the range crosses into the next M tile
        __syncthreads();  // every warp is done with the old x
        m0 = tm0;
        load_x(m0);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
      }
      col0 = tile % n_tiles * kXsBN + warp * 32 + 8 * t;
      col_ok = col0 < N;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        sc[c] = col_ok ? __ldg(p.scale + col0 + c) : 0.f;
        zc[c] = ZP && col_ok ? __ldg(p.zp + col0 + c) : 0.f;
      }
    }
    cp_async_wait<kXsStages - 2>();
    __syncthreads();  // stage q landed; every warp is done with stage q - 1
    if (q + kXsStages - 1 < total) load_w(q + kXsStages - 1);
    cp_async_commit();

    const uint8_t* wbuf = smem + (q % kXsStages) * kXsWBytes;
    const int ns = min(4, slices - st * 4);
    for (int sl = 0; sl < ns; ++sl) {
      const int c = st * 4 + sl;
      uint32_t a[WM][4];
#pragma unroll
      for (int mt = 0; mt < WM; ++mt)
        ldmatrix_x4(a[mt], xres + ((warp_m * WM + mt) * 16 + (lane & 15)) * xpitch +
                               c * kSlice + (lane >> 4) * 8);
      const uint8_t* wrow = wbuf + (sl * kSlice + 2 * t) * kXsWPitch + warp * 32 + 4 * g;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(wrow) ^ p.flip;
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(wrow + kXsWPitch) ^ p.flip;
      const uint32_t w8 = *reinterpret_cast<const uint32_t*>(wrow + 8 * kXsWPitch) ^ p.flip;
      const uint32_t w9 = *reinterpret_cast<const uint32_t*>(wrow + 9 * kXsWPitch) ^ p.flip;
      uint32_t b0[4], b1[4];
      b0[0] = byte_pair<0>(w0, w1, p.magic);
      b0[1] = byte_pair<1>(w0, w1, p.magic);
      b0[2] = byte_pair<2>(w0, w1, p.magic);
      b0[3] = byte_pair<3>(w0, w1, p.magic);
      b1[0] = byte_pair<0>(w8, w9, p.magic);
      b1[1] = byte_pair<1>(w8, w9, p.magic);
      b1[2] = byte_pair<2>(w8, w9, p.magic);
      b1[3] = byte_pair<3>(w8, w9, p.magic);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int mt = 0; mt < WM; ++mt) mma_bf16(d[mt][j], a[mt], b0[j], b1[j]);
      if constexpr (ZP) {
#pragma unroll
        for (int mt = 0; mt < WM; ++mt) mma_bf16(xs[mt], a[mt], kOnes, kOnes);
      }
    }
    if (st == n_stages - 1) {
      // The tile's one fold, (d - xsum * zp) * s, stored from the C fragments.
#pragma unroll
      for (int mt = 0; mt < WM; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + (warp_m * WM + mt) * 16 + g + 8 * h;
          if (!col_ok || m >= p.M) continue;
          float o[8];
#pragma unroll
          for (int q2 = 0; q2 < 2; ++q2)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int e = 2 * h + q2, c = 4 * q2 + j;
              float v = d[mt][j][e];
              if constexpr (ZP) v -= xs[mt][2 * h] * zc[c];
              o[c] = v * sc[c];
            }
          float4* dst = reinterpret_cast<float4*>(p.out + static_cast<size_t>(m) * N + col0);
          dst[0] = make_float4(o[0], o[1], o[2], o[3]);
          dst[1] = make_float4(o[4], o[5], o[6], o[7]);
        }
      clear();
    }
  }
  cp_async_wait<0>();
}

template <int WM, int WARPS_M, bool ZP>
int launch_xs(const W8Args& p, cudaStream_t stream) {
  constexpr int kBM = WM * 16 * WARPS_M;
  auto kernel = w8_mma_xs_kernel<WM, WARPS_M, ZP>;
  const int smem = xs_smem_bytes(kBM, p.K);
  static int sms = 0;  // the card's SMs: one block each (the x tile fills shared memory)
  if (sms == 0) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (p.M + kBM - 1) / kBM * ((p.N + kXsBN - 1) / kXsBN);
  const int blocks = tiles < sms ? tiles : sms;
  const int per_block = (tiles + blocks - 1) / blocks;
  kernel<<<(tiles + per_block - 1) / per_block, 256 * WARPS_M, smem, stream>>>(p, per_block);
  return static_cast<int>(cudaGetLastError());
}

// The tiles of the plan: 16, 32 or 64 rows by 128 columns, one warp along M
// (each weight byte is converted once a block), or the x-stationary form.
template <bool ONE_TILE>
int dispatch_mma(const W8Args& p, int bm, int bn, cudaStream_t st) {
  if (bn == kXsBN) {  // x-stationary: a single K tile only
    if (!ONE_TILE || xs_smem_bytes(bm, p.K) > 227 * 1024)
      return static_cast<int>(cudaErrorInvalidValue);
    // 128 rows: one warp along M, or two with the zero point's row sums (the
    // registers of one warp would spill).
    if (bm == 128) return p.zp == nullptr ? launch_xs<8, 1, false>(p, st)
                                          : launch_xs<4, 2, true>(p, st);
    if (bm == 64) return p.zp == nullptr ? launch_xs<4, 1, false>(p, st)
                                         : launch_xs<4, 1, true>(p, st);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bn == 128 && bm == 16) return launch_mma<1, 1, 4, ONE_TILE>(p, st);
  if (bn == 128 && bm == 32) return launch_mma<2, 1, 4, ONE_TILE>(p, st);
  if (bn == 128 && bm == 64) return launch_mma<4, 1, 4, ONE_TILE>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x_bf16: 1 for bfloat16 x, 0 for float32. is_signed: int8 (1) or uint8 (0).
// symmetric: zero point is 0 (zp may be null). The launch plan
// (ops/kernels/matmul_w8.py::w8_plan): route 1 is the mma route (bf16 x, bk
// and N multiples of 16, x and w 16-byte aligned), 0 the simt route; bm, bn
// the block tile (mma: bn 256 is the x-stationary form, bk == K only; simt:
// bm 32 or 64 rows, bn 128 for four columns a thread, which needs N % 4 ==
// 0, else 32); split_slices the 16-row slices of K a
// block walks (mma route; the grid has ceil(K / 16 / split_slices) blocks
// along K). ws holds splits * tiles * bm * bn floats and counters one zeroed
// uint32 a tile when the plan splits K; both may be null otherwise.
// Returns cudaGetLastError() after the launch.
extern "C" int oqt_w8_matmul(const void* x, int x_bf16, const void* w, const void* scale,
                             const void* zp, void* out, int M, int K, int N, int bk,
                             int is_signed, int symmetric, int route, int bm, int bn,
                             int split_slices, void* ws, void* counters, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (!x_bf16 || bk % kSlice != 0 || K % bk != 0 || N % 16 != 0 || split_slices <= 0)
      return static_cast<int>(cudaErrorInvalidValue);
    if (reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
    if (K / kSlice > split_slices && (ws == nullptr || counters == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    const W8Args p{static_cast<const uint16_t*>(x),
                   static_cast<const uint8_t*>(w),
                   static_cast<const float*>(scale),
                   symmetric ? nullptr : static_cast<const float*>(zp),
                   static_cast<float*>(out),
                   static_cast<float*>(ws),
                   static_cast<unsigned int*>(counters),
                   M,
                   K,
                   N,
                   bk / kSlice,
                   split_slices,
                   is_signed ? 0x80808080u : 0u,
                   is_signed ? 8388736.f : 8388608.f};
    return bk == K ? dispatch_mma<true>(p, bm, bn, st) : dispatch_mma<false>(p, bm, bn, st);
  }
  const int sign_off = is_signed ? 128 : 0;
  const bool cols4 = bn == 128;
  if (x_bf16) {
    dispatch_simt<__nv_bfloat16>(x, w, scale, zp, out, M, K, N, bk, sign_off, symmetric, bm,
                                 cols4, st);
  } else {
    dispatch_simt<float>(x, w, scale, zp, out, M, K, N, bk, sign_off, symmetric, bm, cols4, st);
  }
  return static_cast<int>(cudaGetLastError());
}
