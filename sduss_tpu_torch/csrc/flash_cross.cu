// Short-KV cross-attention for Hopper (sm_90a), bf16 in/out: kernel K5.
//
// Replaces sduss_tpu/ops/flash.py::_cross_short_kernel (the Pallas TPU
// kernel behind flash_cross_short): softmax(Q K^T * scale) V for a key
// sequence of at most 256 tokens (the 77 text tokens of cross-attention),
// Q and O in (B, Lq, D) model layout with head h at columns
// [h*hd, h*hd+hd).  K and V stay in model layout too: the TPU wrapper's
// head-major transpose of K/V is a VMEM layout choice, and a block here
// reads its head's columns straight from the rows.  The port's dispatcher
// (ops/attention.py) sends every unmasked attention over fewer than 128
// keys here.  The JAX dispatcher keeps that attention dense because on a
// v5e the Pallas kernel was slower than XLA's dense attention; on the H100
// the plain route is 4-16x slower than this kernel.
//
// What bounds it on this card: device-memory bytes.  Per call it must read
// Q and write O (B*Lq*D bf16 each) and read the small K/V once; the work is
// 4*B*Lq*Lk*D FLOP, Lk FLOP per byte of Q and O (77 for text keys), far
// below the ~295 at which the tensor cores become the limit.  Measured at
// the serving shapes (PERF.md) it moves 1.2-2.4 TB/s: the per-tile stream
// of ldmatrix, mma.sync and softmax instructions sets its time more than
// the bytes do -- a third Q buffer, a larger grid or two row tiles a warp
// change little; straight-line code per key count (no guarded loops) is
// what lowered it most.
//
// Design (K/V resident, Q streamed; the register layout of flash_fused.cu):
//   grid (query-tile runs, H, B).  A block owns one (batch row, head) and a
//   run of consecutive query tiles (WARPS * MT * 16 = 64 rows each), sized
//   at launch so the grid is a few waves of the card's SMs: K and V of its
//   head are loaded once per block, not once per query tile.  K/V land in
//   shared memory by cp.async (16 B); key rows Lk..lkp-1 (lkp = Lk rounded
//   up to 16) are zero-filled, since stale shared memory can hold NaN and
//   0 * NaN would poison P V.  Q tiles stream through a 2-stage cp.async
//   buffer: tile t+1 is in flight while tile t is computed.  Each warp owns
//   MT m16 row tiles of the query tile (they share its K and V fragment
//   loads); S, P and O live in registers on mma.sync.m16n8k16 (Q by
//   ldmatrix, one k16 step at a time; K by ldmatrix; V by ldmatrix.trans;
//   P straight from the score accumulators); hd 40 ends Q K^T with one
//   m16n8k8 step and P V with an n8 tile.  Keys go in chunks of KEYS = 128
//   with an online rescale between chunks (77 keys are one chunk, 256
//   two), so the scores of one chunk (at most 64 floats a lane) and O
//   (hd/2 floats) fit the register file without a spill at every head
//   dim.  A chunk's code is instantiated for its number of
//   16-key groups (picked at run time), so its loops are straight-line
//   code and groups past the last key are never computed.  The scale is
//   folded into one FMA before ex2; pad keys get -inf.  Rows are reduced
//   over the 4 lanes of a quad by shuffles.  O is normalised once, staged
//   through the warp's own rows of the Q buffer (free once the last chunk
//   has read them) and written in 16-byte vectors.  Shared rows have an
//   odd number of 16-byte units (hd 40: 80 B; 64/80/160: +16 B), so
//   ldmatrix is conflict-free.

#include <math.h>

#include "mma_frag.cuh"

namespace {

constexpr int MAX_KV = 256;  // keys a block holds whole

// Block shape: WARPS warps of MT m16 row tiles each (a query tile of
// WARPS * MT * 16 rows), STAGES query-tile buffers, KEYS keys per softmax
// chunk, and the grid's target of BLOCKS_PER_SM blocks per SM
// (scripts/tune_cross_shapes.py measures them; PERF.md has the numbers).
constexpr int WARPS = 4, MT = 1, STAGES = 2, KEYS = 128, BLOCKS_PER_SM = 8;

template <int HD>
struct CrossTile {
  static constexpr int CH = KEYS;
  static constexpr int THREADS = WARPS * 32;
  static constexpr int BQ = WARPS * MT * 16;        // query rows per tile
  static constexpr int VEC = HD / 8;                // 16-byte vectors a row
  static constexpr int LD = VEC % 2 ? HD : HD + 8;  // shared row stride
  static constexpr int KS = HD / 16;                // k16 steps of Q K^T
  static constexpr bool TAIL = HD % 16 != 0;        // one more 8-wide step
  static constexpr int NO = HD / 8;                 // n8 output tiles
  static_assert(STAGES >= 2 && CH % 16 == 0, "block shape");
};

// Dynamic shared memory for lkp (padded) keys: K, V, STAGES Q tiles.
template <int HD>
size_t smem_bytes(int lkp) {
  using T = CrossTile<HD>;
  return (size_t)(2 * lkp + STAGES * T::BQ) * T::LD * sizeof(bf16);
}

// Start copying rows [row0, row0 + rows) x the head's HD columns of a
// (n, D) matrix (src at the head's first column) into shared memory; rows
// at or past n are zero-filled and read from row n - 1 (n >= 1).
template <int HD>
__device__ __forceinline__ void load_head_rows(bf16* dst, const bf16* src,
                                               int row0, int rows, int n,
                                               int D, int tid) {
  using T = CrossTile<HD>;
  for (int i = tid; i < rows * T::VEC; i += T::THREADS) {
    const int r = i / T::VEC;
    const int c = (i - r * T::VEC) * 8;
    const int gr = row0 + r;
    const bool ok = gr < n;
    cp_async16(dst + r * T::LD + c, src + (size_t)(ok ? gr : n - 1) * D + c,
               ok);
  }
}

// One chunk of NG 16-key groups (keys c0 .. c0 + 16*NG of the block's K
// and V, from Kc and Vc) for the warp's MT row tiles of Q (rows of wQ):
// S = Q K^T, -inf on pad keys (keys_left = Lk - c0), the online softmax
// update of m_run, l_run and acc, and O += P V.  NG is a template constant,
// so every loop is straight-line code; chunk_of picks the instantiation.
template <int HD, int NG>
__device__ __forceinline__ void chunk(
    float (&acc)[MT][CrossTile<HD>::NO][4], float (&m_run)[MT][2],
    float (&l_run)[MT][2], const bf16* wQ, const bf16* Kc, const bf16* Vc,
    int keys_left, int lane, float sl2, bool zero, uint32_t q_xor) {
  using T = CrossTile<HD>;
  constexpr int LD = T::LD, NS = 2 * NG;  // n8 score tiles
  float s[MT][NS][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) s[mt][j][r] = 0.f;
    }
  }
  // S = Q K^T, one k16 step of the head at a time, so one Q fragment per
  // row tile is live (read again from shared memory per chunk): registers
  // go to the chunk's scores and O.  Q: ldmatrix.x4 over (rows 0-7 | 8-15)
  // x (cols 0-7 | 8-15) of each 16x16 block.  K: ldmatrix.x4 matrix
  // i = lane/8 covers keys 16p + (i/2)*8 and head columns 16ks + (i%2)*8:
  // b0, b1 of score tiles 2p, 2p+1, shared by the warp's row tiles.
  const bf16* q_row = wQ + (lane & 15) * LD + (lane >> 4) * 8;
  const int mi = lane >> 3;
#pragma unroll
  for (int ks = 0; ks < T::KS; ++ks) {
    uint32_t qa[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      ldsm_x4(qa[mt], q_row + mt * 16 * LD + ks * 16);
#pragma unroll
      for (int r = 0; r < 4; ++r) qa[mt][r] = zero ? 0u : qa[mt][r] ^ q_xor;
    }
#pragma unroll
    for (int p = 0; p < NG; ++p) {
      uint32_t kf[4];
      ldsm_x4(kf, Kc + (p * 16 + (mi >> 1) * 8 + (lane & 7)) * LD + ks * 16 +
                      (mi & 1) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_k16(s[mt][2 * p], qa[mt], kf[0], kf[1]);
        mma_k16(s[mt][2 * p + 1], qa[mt], kf[2], kf[3]);
      }
    }
  }
  if constexpr (T::TAIL) {  // head columns [HD-8, HD) by m16n8k8
    uint32_t qt[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      ldsm_x2(qt[mt], wQ + (mt * 16 + (lane & 15)) * LD + T::KS * 16);
#pragma unroll
      for (int r = 0; r < 2; ++r) qt[mt][r] = zero ? 0u : qt[mt][r] ^ q_xor;
    }
#pragma unroll
    for (int p = 0; p < NG; ++p) {
      uint32_t kf[2];
      ldsm_x2(kf, Kc + (p * 16 + (lane & 15)) * LD + T::KS * 16);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_k8(s[mt][2 * p], qt[mt], kf[0]);
        mma_k8(s[mt][2 * p + 1], qt[mt], kf[1]);
      }
    }
  }
  if (keys_left < 16 * NG) {  // pad keys (Lk..lkp-1) in the last group
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int key = j * 8 + 2 * (lane & 3);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (key >= keys_left) s[mt][j][0] = s[mt][j][2] = -INFINITY;
        if (key + 1 >= keys_left) s[mt][j][1] = s[mt][j][3] = -INFINITY;
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
      for (int j = 0; j < NS; ++j) {
        mx = fmaxf(mx, fmaxf(s[mt][j][2 * h], s[mt][j][2 * h + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(FULL_WARP, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL_WARP, mx, 2));
      const float m_new = fmaxf(m_run[mt][h], mx);
      const float alpha = ex2((m_run[mt][h] - m_new) * sl2);  // 0 at first
      m_run[mt][h] = m_new;
      const float mb = m_new * sl2;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          s[mt][j][e] = ex2(fmaf(s[mt][j][e], sl2, -mb));
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
  // and head columns 16p + (i/2)*8: b0, b1 of output tiles 2p, 2p+1.
#pragma unroll
  for (int c = 0; c < NG; ++c) {
    uint32_t pa[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      pa[mt][0] = pack_bf16(s[mt][2 * c][0], s[mt][2 * c][1]);
      pa[mt][1] = pack_bf16(s[mt][2 * c][2], s[mt][2 * c][3]);
      pa[mt][2] = pack_bf16(s[mt][2 * c + 1][0], s[mt][2 * c + 1][1]);
      pa[mt][3] = pack_bf16(s[mt][2 * c + 1][2], s[mt][2 * c + 1][3]);
    }
    const bf16* vrow = Vc + (c * 16 + (mi & 1) * 8 + (lane & 7)) * LD;
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

// chunk<HD, ng> for a block-uniform ng in [1, NG].
template <int HD, int NG, typename... Args>
__device__ __forceinline__ void chunk_of(int ng, Args&&... args) {
  if constexpr (NG > 1) {
    if (ng < NG) {
      chunk_of<HD, NG - 1>(ng, static_cast<Args&&>(args)...);
      return;
    }
  }
  chunk<HD, NG>(static_cast<Args&&>(args)...);
}

template <int HD>
__global__ void __launch_bounds__(CrossTile<HD>::THREADS)
cross_short_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o, int Lq,
                   int Lk, int lkp, int D, int tiles_per_block,
                   float scale_log2) {
  using T = CrossTile<HD>;
  constexpr int LD = T::LD, BQ = T::BQ, CH = T::CH;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + lkp * LD;
  bf16* sQ = sV + lkp * LD;  // STAGES tiles of BQ rows

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int col0 = blockIdx.y * HD;
  const int b = blockIdx.z;
  const int t0 = blockIdx.x * tiles_per_block;
  const int t1 = min(t0 + tiles_per_block, (Lq + BQ - 1) / BQ);
  const bf16* qb = q + (size_t)b * Lq * D + col0;
  bf16* ob = o + (size_t)b * Lq * D + col0;

  // K, V and the first Q tile: one commit group; then one group per Q
  // tile (empty past the run's end), so wait_group<STAGES-2> at tile t
  // always means "tile t has landed".
  load_head_rows<HD>(sK, k + (size_t)b * Lk * D + col0, 0, lkp, Lk, D, tid);
  load_head_rows<HD>(sV, v + (size_t)b * Lk * D + col0, 0, lkp, Lk, D, tid);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (t0 + st < t1) {
      load_head_rows<HD>(sQ + st * BQ * LD, qb, (t0 + st) * BQ, BQ, Lq, D,
                         tid);
    }
    cp_async_commit();
  }

  // The folded softmax takes a positive scale: softmax(s * c) =
  // softmax(-s * |c|), so a negative scale negates Q (exact in bf16); at
  // c = 0 every key weighs the same, so Q becomes 0 and c 1.
  const bool negate = scale_log2 < 0.f, zero = scale_log2 == 0.f;
  const float sl2 = zero ? 1.f : fabsf(scale_log2);
  const uint32_t q_xor = negate ? 0x80008000u : 0u;

  for (int t = t0; t < t1; ++t) {
    // this warp's MT row tiles of 16 query rows
    bf16* wQ = sQ + ((t - t0) % STAGES) * BQ * LD + warp * MT * 16 * LD;
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile t visible; every warp has stored tile t-1
    const int next = t + STAGES - 1;
    if (next < t1) {
      load_head_rows<HD>(sQ + ((next - t0) % STAGES) * BQ * LD, qb,
                         next * BQ, BQ, Lq, D, tid);
    }
    cp_async_commit();

    // Rows lane/4 (index 0) and lane/4 + 8 (index 1) of each row tile; the
    // output fragment of n8 tile j holds columns 8j + 2*(lane%4) + {0, 1}.
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

    // Every chunk starts below Lk, so each holds a valid key and each row
    // max is finite.
    for (int c0 = 0; c0 < lkp; c0 += CH) {
      chunk_of<HD, CH / 16>(min(CH, lkp - c0) / 16, acc, m_run, l_run, wQ,
                            sK + c0 * LD, sV + c0 * LD, Lk - c0, lane, sl2,
                            zero, q_xor);
    }

    // O / l through this warp's rows of the Q buffer, then out in 16-byte
    // vectors: col0 = h * hd with hd % 8 == 0 keeps them aligned.
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float inv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float l = l_run[mt][h];
        l += __shfl_xor_sync(FULL_WARP, l, 1);
        l += __shfl_xor_sync(FULL_WARP, l, 2);
        inv[h] = 1.f / l;  // l >= 1: the row max's own term
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
    const int q0 = t * BQ + warp * MT * 16;
#pragma unroll
    for (int i = lane; i < MT * 16 * T::VEC; i += 32) {
      const int r = i / T::VEC;
      const int c = (i - r * T::VEC) * 8;
      if (q0 + r < Lq) {
        *reinterpret_cast<uint4*>(ob + (size_t)(q0 + r) * D + c) =
            *reinterpret_cast<const uint4*>(wQ + r * LD + c);
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess) {
      n = 132;
    }
  }
  return n;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Lq, int Lk, int D, int H, float scale_log2, void* stream) {
  const int lkp = (Lk + 15) / 16 * 16;
  const size_t smem = smem_bytes<HD>(lkp);
  cudaError_t err = cudaFuncSetAttribute(
      cross_short_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  // Query tiles per block: as many as keep about BLOCKS_PER_SM blocks per
  // SM, spread evenly over the runs of one (batch row, head).
  using T = CrossTile<HD>;
  const int n_tiles = (Lq + T::BQ - 1) / T::BQ;
  const long long all = (long long)n_tiles * H * B;
  const long long want = (long long)sm_count() * BLOCKS_PER_SM;
  int per = (int)(all / want > 1 ? all / want : 1);
  per = per < n_tiles ? per : n_tiles;
  const int runs = (n_tiles + per - 1) / per;
  per = (n_tiles + runs - 1) / runs;
  const dim3 grid(runs, H, B);
  cross_short_kernel<HD><<<grid, T::THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), Lq, Lk, lkp, D, per,
      scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o: contiguous bf16 (B, Lq, D); k, v: contiguous bf16 (B, Lk, D) with
// 1 <= Lk <= 256; D = H * hd, hd one of 40, 64, 80, 160; one device.
// scale_log2 = softmax scale * log2(e).  Launches on `stream` and returns
// cudaGetLastError() (0 = launched); an unsupported shape is refused.
extern "C" int sduss_flash_cross_short(const void* q, const void* k,
                                       const void* v, void* o, int B, int Lq,
                                       int Lk, int D, int H, float scale_log2,
                                       void* stream) {
  if (Lk < 1 || Lk > MAX_KV || H < 1 || D % H != 0) {
    return (int)cudaErrorInvalidValue;
  }
  switch (D / H) {
    case 40:
      return launch<40>(q, k, v, o, B, Lq, Lk, D, H, scale_log2, stream);
    case 64:
      return launch<64>(q, k, v, o, B, Lq, Lk, D, H, scale_log2, stream);
    case 80:
      return launch<80>(q, k, v, o, B, Lq, Lk, D, H, scale_log2, stream);
    case 160:
      return launch<160>(q, k, v, o, B, Lq, Lk, D, H, scale_log2, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
