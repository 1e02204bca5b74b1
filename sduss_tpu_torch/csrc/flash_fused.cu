// Model-layout flash self-attention for Hopper (sm_90a), bf16 in/out.
//
// Three entries over one template:
//   K1, MASKED = false (sduss_flash_mha_fused): replaces
//       sduss_tpu/ops/flash.py::_mha_fused_kernel (the Pallas TPU kernel
//       behind flash_mha_fused);
//   K2a/K3b, MASKED = false with kv_len <= Lk (sduss_flash_mha): replaces
//       sduss_tpu/ops/flash.py::_mha_kernel_2pass_nobias, ::_mha_kernel and
//       the kv_len form of ::_mha_kernel_2pass (flash_mha without kv_mask),
//       which compute one function -- softmax over the first kv_len keys --
//       by a two-pass softmax over head-major copies (the first two) or an
//       online one (the third).  The TPU kernels need head-major layouts and
//       128-aligned key axes for VMEM and the MXU; here the key loop simply
//       stops at kv_len while Lk stays the batch stride of K/V, so the SD3
//       widths (D = 1536, H = 24) run on the same code as SDXL's;
//   K2b/K3a, MASKED = true: replaces sduss_tpu/ops/flash.py::_mha_kernel_2pass
//       and ::_mha_kernel_masked (flash_mha with kv_mask), which compute the
//       same function, the first by a two-pass and the second by an online
//       softmax.  The mask is one byte per (batch row, key); masked keys get
//       -inf before the row max.
// All compute softmax(Q K^T * scale) V over (B, L, D) tensors
// whose heads are column slices of D (head h at columns [h*hd, h*hd+hd)),
// so no head transposes are ever materialized.  The head dim hd is a
// template constant, instantiated at 40, 64, 80 and 160 (SD-1.5's 40/80/160
// at 8 heads over 320/640/1280 channels, SDXL's and SD3's 64).  The wmma
// tiles are 16 wide, so a head is held padded to HDP = ceil(hd/16)*16
// columns (40 -> 48): the pad columns of Q, K and V are zero-filled on
// load, add nothing to Q K^T, and the output's pad columns are never
// written.  Computes what the TPU
// kernel computes, not its tiling: the TPU kernel holds whole K/V rows in
// VMEM and runs a two-pass softmax; shared memory here is ~227 KB per SM,
// so K/V stream through it in 64-row tiles under an online softmax.

// Design (one simple, correct kernel; wgmma/TMA/warp specialisation are
// later work):
//   grid (ceil(Lq/64), H, B), 128 threads = 4 warps, each warp owns 16
//   query rows.  Q's 16 x HDP slice lives in wmma fragments for the whole
//   block; 64-row K and V tiles are staged in shared memory; QK^T and PV
//   run on bf16 16x16x16 tensor-core fragments with float32 accumulators.
//   Softmax statistics (running max m, running sum l) are float32, kept in
//   registers by the two lanes that share a row.  The output accumulator is
//   float32 in shared memory so each tile can rescale it by exp2(m_old -
//   m_new) row by row (wmma accumulator layouts are opaque).  Ragged Lq and
//   kv_len tiles are zero-filled on load; key columns at or past kv_len get
//   -inf scores, and no key past kv_len is ever read.
//
// What bounds it on this card: attention at SDXL shapes is compute-bound
// in principle (L=4096, hd=64: ~64 FLOP per byte of K/V per query tile,
// K/V of one head is 1 MB and stays in the 50 MB L2).  This design is
// bound instead by shared-memory traffic and instruction count: every
// tile writes the 16x64 f32 scores, reads them back for the softmax,
// writes bf16 probabilities and round-trips the f32 output accumulator.  The fast
// version keeps S/P/O in registers (mma.sync or wgmma layouts) and
// pipelines K/V loads with cp.async/TMA.
//
// Masked variant: every row of a block belongs to one batch row, so the
// mask of a key tile is the same for all of the block's rows.  The block
// reads the tile's 64 mask bytes first and skips the tile entirely (no K/V
// load, no math) when none is set; a processed tile has >= 1 valid key, so
// every row's running max stays finite and exp2(-inf - m) is 0 for masked
// keys.  A batch row whose keys are all masked (a padded image slot of the
// patch path) processes no tile: l stays 0 and its output is written as
// zeros, a defined finite value.  Skipped tiles also cost nothing, so the
// work follows the real keys.  The bound is as above: the same FLOPs per
// valid key tile, plus 64 bytes of mask per tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;            // query rows per block
constexpr int BK = 64;            // key/value rows per tile
constexpr int WARPS = 4;          // 16 query rows each
constexpr int THREADS = WARPS * 32;
constexpr int P_LD = BK + 8;      // padded bf16 probability row
constexpr int F_LD = BK + 4;      // padded f32 score row

// Shared-memory layout for head dim HD.  At hd 64 every stride and size is
// the one the kernel had before it took other head dims.
template <int HD>
struct Tile {
  static constexpr int HDP = (HD + 15) / 16 * 16;  // head padded for wmma
  static constexpr int LD = HDP + 8;     // padded bf16 Q/K/V row (banks)
  static constexpr int O_LD = HDP + 4;   // padded f32 output row
  static constexpr int SQ = BQ * LD;
  static constexpr int SKV = BK * LD;
  static constexpr int SP = WARPS * 16 * P_LD;
  static constexpr int SS = WARPS * 16 * F_LD;
  static constexpr int SO = WARPS * 16 * O_LD;
  // 70 KB at hd 64, 130 KB at hd 160 (one block per SM there)
  static constexpr size_t SMEM_BYTES =
      (size_t)(SQ + 2 * SKV + SP) * sizeof(bf16) +
      (size_t)(SS + SO) * sizeof(float);
};

// Copy rows [row0, row0+64) x cols [col0, col0+HD) of a (L, D) bf16 matrix
// into shared memory, 16 bytes per thread per step; rows >= L and the pad
// columns [HD, HDP) become 0.
template <int HD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int row0, int L, int D,
                                          int col0, int tid) {
  constexpr int VEC = Tile<HD>::HDP / 8;  // 16-byte vectors per padded row
  for (int i = tid; i < 64 * VEC; i += THREADS) {
    const int r = i / VEC;
    const int c = (i % VEC) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    const int gr = row0 + r;
    if (gr < L && c < HD) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)gr * D + col0 + c);
    }
    *reinterpret_cast<uint4*>(dst + r * Tile<HD>::LD + c) = val;
  }
}

template <int HD, bool MASKED>
__global__ void __launch_bounds__(THREADS)
mha_fused_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 const uint8_t* __restrict__ kv_mask,
                 int Lq, int Lk, int kv_len, int D, float scale_log2) {
  using T = Tile<HD>;
  constexpr int HDP = T::HDP;
  constexpr int LD = T::LD;
  constexpr int O_LD = T::O_LD;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint8_t sMask[BK];  // MASKED: this key tile's validity
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + T::SQ;
  bf16* sV = sK + T::SKV;
  bf16* sP = sV + T::SKV;
  float* sS = reinterpret_cast<float*>(sP + T::SP);
  float* sO = sS + T::SS;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * BQ;
  const int col0 = blockIdx.y * HD;
  const int b = blockIdx.z;
  const bf16* qb = q + (size_t)b * Lq * D;
  const bf16* kb = k + (size_t)b * Lk * D;
  const bf16* vb = v + (size_t)b * Lk * D;

  float* wS = sS + warp * 16 * F_LD;   // this warp's 16x64 scores
  float* wO = sO + warp * 16 * O_LD;   // this warp's 16xHDP output acc
  bf16* wP = sP + warp * 16 * P_LD;    // this warp's 16x64 probabilities

  load_tile<HD>(sQ, qb, q0, Lq, D, col0, tid);
  for (int i = lane; i < 16 * HDP; i += 32) wO[(i / HDP) * O_LD + i % HDP] = 0.f;
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[HDP / 16];
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    wmma::load_matrix_sync(qf[kk], sQ + warp * 16 * LD + kk * 16, LD);
  }

  // Two lanes per query row, each owning 32 of the tile's 64 key columns
  // and HDP/2 of the output accumulator's columns.
  const int row = lane >> 1;
  const int half = lane & 1;
  float m = -INFINITY;
  float l = 0.f;

  // Lk is the batch stride of K/V; keys at or past kv_len take no part
  // (kv_len == Lk except for the sduss_flash_mha entry).
  for (int kv0 = 0; kv0 < kv_len; kv0 += BK) {
    if constexpr (MASKED) {
      // Block-uniform: skip a tile with no valid key (see the header).
      uint8_t valid_key = 0;
      if (tid < BK) {
        valid_key = (kv0 + tid < kv_len) ? kv_mask[(size_t)b * Lk + kv0 + tid]
                                         : (uint8_t)0;
        sMask[tid] = valid_key;
      }
      if (!__syncthreads_or(valid_key != 0)) continue;
    }
    load_tile<HD>(sK, kb, kv0, kv_len, D, col0, tid);
    load_tile<HD>(sV, vb, kv0, kv_len, D, col0, tid);
    __syncthreads();

    // S = Q K^T: K is (kv, hd) row-major in smem, i.e. K^T col-major.
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, sK + n * 16 * LD + kk * 16, LD);
        wmma::mma_sync(acc, qf[kk], kf, acc);
      }
      wmma::store_matrix_sync(wS + n * 16, acc, F_LD, wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax on this lane's half row (base-2 exponent, f32).
    const int valid = min(BK, kv_len - kv0);
    float* srow = wS + row * F_LD + half * 32;
    float mx = -INFINITY;
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      bool keep = half * 32 + j < valid;
      if constexpr (MASKED) keep = keep && sMask[half * 32 + j] != 0;
      const float s = keep ? srow[j] * scale_log2 : -INFINITY;
      srow[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);  // finite: every processed tile has a key
    const float alpha = exp2f(m - m_new);   // 0 on the first tile
    bf16* prow = wP + row * P_LD + half * 32;
    float sum = 0.f;
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const float p = exp2f(srow[j] - m_new);
      sum += p;
      prow[j] = __float2bfloat16(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = l * alpha + sum;
    m = m_new;
    float* orow = wO + row * O_LD + half * (HDP / 2);
#pragma unroll 8
    for (int j = 0; j < HDP / 2; ++j) orow[j] *= alpha;
    __syncwarp();

    // O += P V: V is (kv, hd) row-major in smem.
#pragma unroll
    for (int n = 0; n < HDP / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, wO + n * 16, O_LD, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, wP + kk * 16, P_LD);
        wmma::load_matrix_sync(vf, sV + kk * 16 * LD + n * 16, LD);
        wmma::mma_sync(acc, pf, vf, acc);
      }
      wmma::store_matrix_sync(wO + n * 16, acc, O_LD, wmma::mem_row_major);
    }
    __syncthreads();  // all warps done with sK/sV before the next load
  }

  const int gq = q0 + warp * 16 + row;
  if (gq < Lq) {
    // l == 0 only for a fully masked row, whose accumulator is still 0
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const float* orow = wO + row * O_LD;
    bf16* dst = o + ((size_t)b * Lq + gq) * D + col0;
    // The row's hd/8 16-byte vectors, split between its two lanes (hd 40:
    // 3 + 2).  Global offsets stay 16-byte aligned: col0 = h * hd, hd % 8 == 0.
    constexpr int NV = HD / 8;
    constexpr int SPLIT = (NV + 1) / 2;
#pragma unroll
    for (int vec = half * SPLIT; vec < (half ? NV : SPLIT); ++vec) {
      const int c = vec * 8;
      __align__(16) bf16 tmp[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) tmp[j] = __float2bfloat16(orow[c + j] * inv);
      *reinterpret_cast<uint4*>(dst + c) = *reinterpret_cast<const uint4*>(tmp);
    }
  }
}

template <int HD, bool MASKED>
int launch(const void* q, const void* k, const void* v, const void* kv_mask,
           void* o, int B, int Lq, int Lk, int kv_len, int D, int H,
           float scale_log2, void* stream) {
  constexpr size_t smem = Tile<HD>::SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      mha_fused_kernel<HD, MASKED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Lq + BQ - 1) / BQ, H, B);
  mha_fused_kernel<HD, MASKED><<<grid, THREADS, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<const uint8_t*>(kv_mask), Lq, Lk, kv_len, D, scale_log2);
  return (int)cudaGetLastError();
}

// The instantiation for head dim D / H; an unsupported one is refused
// (the wrappers in ops/flash.py raise before this).
template <bool MASKED>
int dispatch(const void* q, const void* k, const void* v, const void* kv_mask,
             void* o, int B, int Lq, int Lk, int kv_len, int D, int H,
             float scale_log2, void* stream) {
  if (H < 1 || D % H != 0) return (int)cudaErrorInvalidValue;
  switch (D / H) {
    case 40:
      return launch<40, MASKED>(q, k, v, kv_mask, o, B, Lq, Lk, kv_len, D, H,
                                scale_log2, stream);
    case 64:
      return launch<64, MASKED>(q, k, v, kv_mask, o, B, Lq, Lk, kv_len, D, H,
                                scale_log2, stream);
    case 80:
      return launch<80, MASKED>(q, k, v, kv_mask, o, B, Lq, Lk, kv_len, D, H,
                                scale_log2, stream);
    case 160:
      return launch<160, MASKED>(q, k, v, kv_mask, o, B, Lq, Lk, kv_len, D, H,
                                 scale_log2, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: contiguous bf16 (B, Lq|Lk, D) with D = H * hd, hd one of 40,
// 64, 80, 160, on one device.  scale_log2 = softmax scale * log2(e).
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int sduss_flash_mha_fused(const void* q, const void* k,
                                     const void* v, void* o, int B, int Lq,
                                     int Lk, int D, int H, float scale_log2,
                                     void* stream) {
  return dispatch<false>(q, k, v, nullptr, o, B, Lq, Lk, Lk, D, H,
                         scale_log2, stream);
}

// As sduss_flash_mha_fused, over the first kv_len keys of each batch row
// (1 <= kv_len <= Lk; Lk stays the batch stride of K/V).  Keys at or past
// kv_len are never read.
extern "C" int sduss_flash_mha(const void* q, const void* k, const void* v,
                               void* o, int B, int Lq, int Lk, int kv_len,
                               int D, int H, float scale_log2, void* stream) {
  return dispatch<false>(q, k, v, nullptr, o, B, Lq, Lk, kv_len, D, H,
                         scale_log2, stream);
}

// As sduss_flash_mha_fused, plus kv_mask: contiguous (B, Lk) bytes, nonzero
// = the key takes part.  Rows of a batch row with no valid key are zeros.
extern "C" int sduss_flash_mha_masked(const void* q, const void* k,
                                      const void* v, const void* kv_mask,
                                      void* o, int B, int Lq, int Lk, int D,
                                      int H, float scale_log2, void* stream) {
  return dispatch<true>(q, k, v, kv_mask, o, B, Lq, Lk, Lk, D, H, scale_log2,
                        stream);
}

extern "C" const char* sduss_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
