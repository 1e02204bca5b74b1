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
// All compute softmax(Q K^T * scale) V over (B, L, D) tensors whose heads
// are column slices of D (head h at columns [h*hd, h*hd+hd)), so no head
// transposes are ever materialized.  The head dim hd is a template constant,
// instantiated at 40, 64, 80 and 160 (SD-1.5's 40/80/160 at 8 heads over
// 320/640/1280 channels, SDXL's and SD3's 64).  Computes what the TPU kernel
// computes, not its tiling: the TPU kernel holds whole K/V rows in VMEM and
// runs a two-pass softmax; shared memory here is ~227 KB per SM, so K/V
// stream through it in 64-key tiles under an online softmax.
//
// Design (FlashAttention-2's register layout on mma.sync):
//   grid (ceil(Lq/BQ), H, B), query tile fastest so the blocks of one head
//   run together and its K/V is read from L2.  Each warp owns MT m16 row
//   tiles (16*MT query rows); Shape<hd> below gives the warps, MT, the key
//   tile and the ring depth of each head dim.  Q is copied into shared
//   memory once and held as bf16 A fragments (ldmatrix).  S = Q K^T and
//   O += P V run on mma.sync.m16n8k16 bf16 -> f32 in registers: K fragments
//   come by ldmatrix (K row-major is K^T column-major, the .col B operand),
//   V fragments by ldmatrix.trans; two adjacent m16n8 score tiles are the
//   m16k16 A fragment of P, so P is never stored.  hd 40 finishes Q K^T with
//   one m16n8k8 step (16 + 16 + 8) and P V tiles the head in n8 steps, so no
//   head dim is padded.  A lane holds rows lane/4 and lane/4 + 8 of each
//   row tile: their running max m (reduced over the 4 lanes of a quad) and
//   their partial row sums l (reduced once, at the end), both f32; the
//   scale is folded into one FMA, p = exp2(s*scale_log2 - m*scale_log2),
//   and the f32 O accumulator is rescaled by exp2(m_old - m_new) in
//   registers.  O is divided by l once and leaves through the warp's Q rows
//   of shared memory in 16-byte vectors.
//   K/V tiles arrive by cp.async.cg (16 B) into a ring of STAGES slots
//   (commit_group / wait_group): tile j+STAGES-1 is in flight while tile j
//   is computed.  Rows at or past kv_len are zero-filled by the copy's
//   src-size operand from a clamped address (no key past kv_len is read)
//   and their scores get -inf.  Shared rows have a stride of an odd number
//   of 16-byte units (hd 40: 80 B as is; 64/80/160: +16 B), so the 8 row
//   addresses of an ldmatrix fall in 8 different bank groups.
//
// Masked variant: the mask is per batch row, so it is the same for all of
// a block's rows.  In its prologue the block turns its batch row's mask
// into one 64-bit word per key tile and lists, in shared memory, the tiles
// with at least one valid key (MASK_CHUNK tiles at a time); the ring walks
// that list only, and a listed tile's bits set -inf scores before the row
// max.  Every processed tile has a valid key, so every row's running max is
// finite and exp2(-inf - m) = 0.  A batch row whose keys are all masked (a
// padded image slot of the patch path) lists no tile: l stays 0 and its
// output is written as zeros, a defined finite value.  The work follows the
// real keys.
//
// What bounds it on this card: Q K^T and P V are 4*Lq*kv_len*hd FLOP per
// (batch row, head) against 2 bytes per element of Q, K, V and O, so at the
// serving shapes the tensor cores, not HBM, are the limit (K/V of a head
// stays in the 50 MB L2).  With mma.sync every warp reads the whole K and V
// tile from shared memory for its own rows: 16 KB per 16-row tile per 64
// keys at hd 64, about twice the tile's tensor time at the SM's 128 B per
// clock of shared-memory bandwidth, which caps this design near half of
// the bf16 peak (MT = 2 halves that traffic per row).  The exponentials
// (one MUFU ex2 per score) come next.  The next step is wgmma on 64-row
// warpgroup tiles, which reads each K/V tile once per warpgroup straight
// from shared memory, with TMA loads and warp-specialised producers.

#include <math.h>

#include "mma_frag.cuh"

namespace {

// Block shape per head dim: WARPS warps of MT m16 row tiles each, key tiles
// of BK rows, STAGES ring slots (measured by scripts/tune_flash_shapes.py;
// PERF.md has the numbers).
template <int HD> struct Shape;
template <> struct Shape<40> { static constexpr int WARPS = 4, MT = 2, BK = 64, STAGES = 3; };
template <> struct Shape<64> { static constexpr int WARPS = 4, MT = 2, BK = 64, STAGES = 3; };
template <> struct Shape<80> { static constexpr int WARPS = 8, MT = 1, BK = 64, STAGES = 2; };
template <> struct Shape<160> { static constexpr int WARPS = 4, MT = 1, BK = 64, STAGES = 2; };

constexpr int MASK_CHUNK = 256;  // key tiles the masked kernel lists at once

template <int HD>
struct Tile {
  using S = Shape<HD>;
  static constexpr int WARPS = S::WARPS, MT = S::MT, BK = S::BK;
  static constexpr int STAGES = S::STAGES;
  static constexpr int THREADS = WARPS * 32;
  static constexpr int BQ = WARPS * MT * 16;       // query rows per block
  static constexpr int VEC = HD / 8;               // 16-byte vectors per row
  static constexpr int LD = VEC % 2 ? HD : HD + 8;  // shared row stride
  static constexpr int KS = HD / 16;               // k16 steps of Q K^T
  static constexpr bool TAIL = HD % 16 != 0;       // one more 8-wide step
  static constexpr int NS = BK / 8;                // n8 score tiles
  static constexpr int NO = HD / 8;                // n8 output tiles
  static constexpr uint64_t ALL_KEYS = BK == 64 ? ~0ull : (1ull << BK) - 1;
  // Q, then STAGES K slots, then STAGES V slots
  static constexpr size_t SMEM_BYTES =
      (size_t)(BQ + 2 * STAGES * BK) * LD * sizeof(bf16);
  static_assert(HD % 8 == 0 && BK % 32 == 0 && BK <= 64, "tile shape");
};

// Start copying rows [row0, row0 + ROWS) x columns [0, HD) of a matrix with
// row stride D (src already at the head's first column) into shared memory;
// rows at or past n are zero-filled and read from row n - 1 (n >= 1).
template <int HD, int ROWS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int row0, int n, int D, int tid) {
  using T = Tile<HD>;
#pragma unroll
  for (int i = tid; i < ROWS * T::VEC; i += T::THREADS) {
    const int r = i / T::VEC;
    const int c = (i % T::VEC) * 8;
    const int gr = row0 + r;
    const bool ok = gr < n;
    cp_async16(dst + r * T::LD + c, src + (size_t)(ok ? gr : n - 1) * D + c,
               ok);
  }
}

template <int HD, bool MASKED>
__global__ void __launch_bounds__(Tile<HD>::THREADS)
mha_fused_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 const uint8_t* __restrict__ kv_mask,
                 int Lq, int Lk, int kv_len, int D, float scale_log2) {
  using T = Tile<HD>;
  constexpr int MT = T::MT, BK = T::BK, LD = T::LD, STAGES = T::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  // MASKED: the chunk's per-tile key bits, then the listed (live) tiles
  __shared__ uint64_t sBits[MASKED ? MASK_CHUNK : 1];
  __shared__ uint64_t sLiveBits[MASKED ? MASK_CHUNK : 1];
  __shared__ int sLive[MASKED ? MASK_CHUNK : 1];
  __shared__ int sCount;
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + T::BQ * LD;
  bf16* sV = sK + STAGES * BK * LD;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * T::BQ;
  const int col0 = blockIdx.y * HD;
  const int b = blockIdx.z;
  const bf16* kb = k + (size_t)b * Lk * D + col0;
  const bf16* vb = v + (size_t)b * Lk * D + col0;
  bf16* wQ = sQ + warp * MT * 16 * LD;  // this warp's Q rows, later its O

  load_rows<HD, T::BQ>(sQ, q + (size_t)b * Lq * D + col0, q0, Lq, D, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // Q as A fragments: ldmatrix.x4 over (rows 0-7 | 8-15) x (cols 0-7 |
  // 8-15) of each 16x16 block; hd 40's last 8 columns by ldmatrix.x2.
  uint32_t qf[MT][T::KS][4];
  uint32_t qt[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const bf16* row = wQ + (mt * 16 + (lane & 15)) * LD;
#pragma unroll
    for (int ks = 0; ks < T::KS; ++ks) {
      ldsm_x4(qf[mt][ks], row + ks * 16 + (lane >> 4) * 8);
    }
    if constexpr (T::TAIL) ldsm_x2(qt[mt], row + T::KS * 16);
  }
  // The folded softmax below takes scale_log2 > 0.  softmax(s * c) =
  // softmax(-s * |c|), so a negative scale negates Q (exact in bf16); at
  // c = 0 every valid key weighs the same, so Q becomes 0 and c 1.
  if (scale_log2 <= 0.f) {
    const bool zero = scale_log2 == 0.f;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int ks = 0; ks < T::KS; ++ks) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          qf[mt][ks][r] = zero ? 0u : qf[mt][ks][r] ^ 0x80008000u;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) qt[mt][r] = zero ? 0u : qt[mt][r] ^ 0x80008000u;
    }
    scale_log2 = zero ? 1.f : -scale_log2;
  }

  // Lane state: rows lane/4 (index 0) and lane/4 + 8 (index 1) of each
  // row tile; the output fragment of n8 tile j holds columns
  // 8j + 2*(lane%4) + {0, 1}.
  float acc[MT][T::NO][4];
  float m_run[MT][2], l_run[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < T::NO; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][j][r] = 0.f;
    }
    m_run[mt][0] = m_run[mt][1] = -INFINITY;
    l_run[mt][0] = l_run[mt][1] = 0.f;
  }

  // Lk is the batch stride of K/V; keys at or past kv_len take no part
  // (kv_len == Lk except for the sduss_flash_mha entry).
  const int n_tiles = (kv_len + BK - 1) / BK;
  constexpr int CHUNK = MASKED ? MASK_CHUNK : (1 << 30);
  for (int c0 = 0; c0 < n_tiles; c0 += CHUNK) {
    int cnt = n_tiles;
    if constexpr (MASKED) {
      // The chunk's key bits, one tile per warp at a time ...
      const int nc = min(CHUNK, n_tiles - c0);
      const uint8_t* mrow = kv_mask + (size_t)b * Lk;
      for (int t = warp; t < nc; t += T::WARPS) {
        const int key = (c0 + t) * BK + lane;
        uint64_t bits = __ballot_sync(FULL_WARP, key < kv_len && mrow[key]);
        if constexpr (BK > 32) {
          bits |= (uint64_t)__ballot_sync(
                      FULL_WARP, key + 32 < kv_len && mrow[key + 32])
                  << 32;
        }
        if (lane == 0) sBits[t] = bits;
      }
      __syncthreads();
      // ... then the list of tiles with a valid key, in key order.
      if (warp == 0) {
        int n = 0;
        for (int t0 = 0; t0 < nc; t0 += 32) {
          const int t = t0 + lane;
          const uint64_t bits = t < nc ? sBits[t] : 0ull;
          const unsigned live = __ballot_sync(FULL_WARP, bits != 0ull);
          if (bits != 0ull) {
            const int pos = n + __popc(live & ((1u << lane) - 1u));
            sLive[pos] = c0 + t;
            sLiveBits[pos] = bits;
          }
          n += __popc(live);
        }
        if (lane == 0) sCount = n;
      }
      __syncthreads();
      cnt = sCount;
    }
    auto tile_at = [&](int i) -> int {
      if constexpr (MASKED) {
        return sLive[i];
      } else {
        return i;
      }
    };
    auto bits_at = [&](int i) -> uint64_t {
      if constexpr (MASKED) {
        return sLiveBits[i];
      } else {
        const int rem = kv_len - i * BK;  // >= 1
        return rem >= BK ? T::ALL_KEYS : (1ull << rem) - 1ull;
      }
    };
    auto load_kv = [&](int slot, int tile) {
      load_rows<HD, BK>(sK + slot * BK * LD, kb, tile * BK, kv_len, D, tid);
      load_rows<HD, BK>(sV + slot * BK * LD, vb, tile * BK, kv_len, D, tid);
    };
    // The ring: one commit group per tile, empty ones past the list's end,
    // so wait_group<STAGES-2> always means "tile i has landed".
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st < cnt) load_kv(st, tile_at(st));
      cp_async_commit();
    }
    for (int i = 0; i < cnt; ++i) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // tile i visible; every warp is done with tile i-1
      const int next = i + STAGES - 1;
      if (next < cnt) load_kv(next % STAGES, tile_at(next));
      cp_async_commit();
      // One key tile: scores, mask, online softmax, P V.
      const bf16* Ks = sK + (i % STAGES) * BK * LD;
      const bf16* Vs = sV + (i % STAGES) * BK * LD;
      const uint64_t bits = bits_at(i);
      float s[MT][T::NS][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int j = 0; j < T::NS; ++j) {
#pragma unroll
          for (int r = 0; r < 4; ++r) s[mt][j][r] = 0.f;
        }
      }
      // S = Q K^T.  ldmatrix.x4 matrix i = lane/8 covers keys 16p + (i/2)*8
      // and head columns 16ks + (i%2)*8: B fragments b0, b1 of score tiles
      // 2p and 2p+1.
#pragma unroll
      for (int ks = 0; ks < T::KS; ++ks) {
#pragma unroll
        for (int p = 0; p < T::NS / 2; ++p) {
          uint32_t kf[4];
          const int mi = lane >> 3;
          ldsm_x4(kf, Ks + (p * 16 + (mi >> 1) * 8 + (lane & 7)) * LD +
                          ks * 16 + (mi & 1) * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_k16(s[mt][2 * p], qf[mt][ks], kf[0], kf[1]);
            mma_k16(s[mt][2 * p + 1], qf[mt][ks], kf[2], kf[3]);
          }
        }
      }
      if constexpr (T::TAIL) {  // head columns [HD-8, HD): keys 32p + 8i
#pragma unroll
        for (int p = 0; p < T::NS / 4; ++p) {
          uint32_t kf[4];
          ldsm_x4(kf, Ks + (p * 32 + lane) * LD + T::KS * 16);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) mma_k8(s[mt][4 * p + e], qt[mt], kf[e]);
          }
        }
      }
      if (bits != T::ALL_KEYS) {  // block-uniform: masked or padded keys
#pragma unroll
        for (int j = 0; j < T::NS; ++j) {
          const int c = j * 8 + 2 * (lane & 3);
          const bool k0 = (bits >> c) & 1, k1 = (bits >> (c + 1)) & 1;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            if (!k0) s[mt][j][0] = s[mt][j][2] = -INFINITY;
            if (!k1) s[mt][j][1] = s[mt][j][3] = -INFINITY;
          }
        }
      }
      // Online softmax per row, on the fragments.
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < T::NS; ++j) {
            mx = fmaxf(mx, fmaxf(s[mt][j][2 * h], s[mt][j][2 * h + 1]));
          }
          mx = fmaxf(mx, __shfl_xor_sync(FULL_WARP, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(FULL_WARP, mx, 2));
          // finite: every processed tile has a valid key
          const float m_new = fmaxf(m_run[mt][h], mx);
          const float alpha = ex2((m_run[mt][h] - m_new) * scale_log2);
          m_run[mt][h] = m_new;
          const float mb = m_new * scale_log2;
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < T::NS; ++j) {
#pragma unroll
            for (int e = 2 * h; e < 2 * h + 2; ++e) {
              s[mt][j][e] = ex2(fmaf(s[mt][j][e], scale_log2, -mb));
              sum += s[mt][j][e];
            }
          }
          l_run[mt][h] = l_run[mt][h] * alpha + sum;
#pragma unroll
          for (int j = 0; j < T::NO; ++j) {
            acc[mt][j][2 * h] *= alpha;
            acc[mt][j][2 * h + 1] *= alpha;
          }
        }
      }
      // O += P V.  Score tiles 2c and 2c+1 are the A fragment of keys
      // [16c, 16c+16); ldmatrix.x4.trans matrix i covers keys 16c + (i%2)*8
      // and head columns 16p + (i/2)*8: b0, b1 of output tiles 2p and 2p+1.
#pragma unroll
      for (int c = 0; c < BK / 16; ++c) {
        uint32_t pa[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          pa[mt][0] = pack_bf16(s[mt][2 * c][0], s[mt][2 * c][1]);
          pa[mt][1] = pack_bf16(s[mt][2 * c][2], s[mt][2 * c][3]);
          pa[mt][2] = pack_bf16(s[mt][2 * c + 1][0], s[mt][2 * c + 1][1]);
          pa[mt][3] = pack_bf16(s[mt][2 * c + 1][2], s[mt][2 * c + 1][3]);
        }
        const int mi = lane >> 3;
        const bf16* vrow = Vs + (c * 16 + (mi & 1) * 8 + (lane & 7)) * LD;
#pragma unroll
        for (int p = 0; p < HD / 16; ++p) {
          uint32_t vf[4];
          ldsm_x4_t(vf, vrow + p * 16 + (mi >> 1) * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_k16(acc[mt][2 * p], pa[mt], vf[0], vf[1]);
            mma_k16(acc[mt][2 * p + 1], pa[mt], vf[2], vf[3]);
          }
        }
        if constexpr (T::TAIL) {  // output columns [HD-8, HD)
          uint32_t vf[2];
          ldsm_x2_t(vf, vrow + (HD / 16) * 16);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_k16(acc[mt][T::NO - 1], pa[mt], vf[0], vf[1]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the slots and the list are free for the next chunk
  }

  // O / l (0 for a row with no valid key, whose accumulator is 0) through
  // this warp's Q rows (its own since the fragments were loaded), then out
  // in 16-byte vectors: col0 = h * hd with hd % 8 == 0 keeps them aligned.
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = l_run[mt][h];
      l += __shfl_xor_sync(FULL_WARP, l, 1);
      l += __shfl_xor_sync(FULL_WARP, l, 2);
      inv[h] = l > 0.f ? 1.f / l : 0.f;
    }
    bf16* row = wQ + (mt * 16 + (lane >> 2)) * LD + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < T::NO; ++j) {
      *reinterpret_cast<uint32_t*>(row + j * 8) =
          pack_bf16(acc[mt][j][0] * inv[0], acc[mt][j][1] * inv[0]);
      *reinterpret_cast<uint32_t*>(row + 8 * LD + j * 8) =
          pack_bf16(acc[mt][j][2] * inv[1], acc[mt][j][3] * inv[1]);
    }
  }
  __syncwarp();
  bf16* ob = o + (size_t)b * Lq * D + col0;
#pragma unroll
  for (int i = lane; i < MT * 16 * T::VEC; i += 32) {
    const int r = i / T::VEC;
    const int c = (i % T::VEC) * 8;
    const int gq = q0 + warp * MT * 16 + r;
    if (gq < Lq) {
      *reinterpret_cast<uint4*>(ob + (size_t)gq * D + c) =
          *reinterpret_cast<const uint4*>(wQ + r * LD + c);
    }
  }
}

template <int HD, bool MASKED>
int launch(const void* q, const void* k, const void* v, const void* kv_mask,
           void* o, int B, int Lq, int Lk, int kv_len, int D, int H,
           float scale_log2, void* stream) {
  using T = Tile<HD>;
  constexpr size_t smem = T::SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      mha_fused_kernel<HD, MASKED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Lq + T::BQ - 1) / T::BQ, H, B);
  mha_fused_kernel<HD, MASKED><<<grid, T::THREADS, smem,
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
