// Short-KV cross-attention for Hopper (sm_90a), bf16 in/out: kernel K5.
//
// Replaces sduss_tpu/ops/flash.py::_cross_short_kernel (the Pallas TPU
// kernel behind flash_cross_short): softmax(Q K^T * scale) V for a key
// sequence of at most 256 tokens (the 77 text tokens of cross-attention),
// Q and O in (B, Lq, D) model layout with head h at columns
// [h*hd, h*hd+hd).  K and V stay in model layout too: the TPU wrapper's
// head-major transpose of K/V is a VMEM layout choice, and a block here
// reads its head's columns straight from the rows.  Like the TPU kernel,
// nothing routes to it: the port's dispatcher (ops/attention.py) keeps
// 77-token cross-attention on the plain path, as the JAX dispatcher keeps it
// dense; the kernel is held and timed against that path by chip_smoke.py.
//
// Design: one block per (64-query tile, head, batch row), 128 threads =
// 4 warps of 16 query rows.  The head's whole K and V (Lk keys padded to
// lkp, a multiple of 16, with zero rows) sit in shared memory, so the
// softmax is exact in one pass: the row max over all keys first, no running
// rescale; padded keys get -inf.  Q's 16 x HDP slice is staged through
// shared memory into wmma fragments; S = Q K^T (bf16 16x16x16 tensor-core
// fragments, float32 accumulators) lands in shared memory for all lkp keys;
// two lanes per row take the max and the sum and write P = p / l in bf16
// over K, which every warp has finished with; O = P V is computed one
// 16-column fragment at a time, staged through the warp's score rows and
// written to global memory in 16-byte vectors.  The head dim is a template
// constant (40, 64, 80, 160), padded to HDP = ceil(hd/16)*16 with zero
// columns.
//
// What bounds it on this card: device-memory bytes.  Per call it must read
// Q and write O (B*Lq*D bf16 each) and read the tiny K/V once; the work is
// 4*B*Lq*Lk*D FLOP, Lk FLOP per byte of Q and O (77 for text keys), far
// below the ~295 at which the tensor cores become the limit.  Each block
// re-reads its head's K/V (at most 2 x 256 x hd bf16) from the L2 cache, not
// from device memory.  This simple kernel keeps S, P and the output staging in shared
// memory; a fast one would keep them in registers (mma.sync) so the block
// is bound by its Q loads and O stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int WARPS = 4;     // 16 query rows each
constexpr int THREADS = WARPS * 32;
constexpr int MAX_KV = 256;  // keys a block holds whole

template <int HD>
struct CrossTile {
  static constexpr int HDP = (HD + 15) / 16 * 16;  // head padded for wmma
  // bf16 Q/K/V row stride: +8 spreads shared-memory banks; hd 160 rows stay
  // unpadded so that K, V and the f32 scores of 256 keys fit the 227 KB a
  // block may use (230,400 bytes).
  static constexpr int LD = HD == 160 ? HDP : HDP + 8;
};

// Bytes of dynamic shared memory for lkp (padded) keys: [K, later P] [V]
// [S, later the output staging]; Q is staged at the base before K/V load.
template <int HD>
size_t smem_bytes(int lkp) {
  constexpr int LD = CrossTile<HD>::LD;
  const size_t q = (size_t)BQ * LD * sizeof(bf16);
  const size_t kv = (size_t)lkp * LD * sizeof(bf16);
  const size_t p = (size_t)BQ * (lkp + 8) * sizeof(bf16);
  const size_t s = (size_t)BQ * (lkp + 4) * sizeof(float);
  const size_t body = (kv > p ? kv : p) + kv + s;
  return q > body ? q : body;
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
cross_short_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o,
                   int Lq, int Lk, int lkp, int D, float scale_log2) {
  constexpr int HDP = CrossTile<HD>::HDP;
  constexpr int LD = CrossTile<HD>::LD;
  constexpr int VEC = HDP / 8;  // 16-byte vectors per padded row
  extern __shared__ __align__(128) unsigned char smem[];
  const int p_ld = lkp + 8;     // bf16 probability row
  const int f_ld = lkp + 4;     // f32 score row
  const size_t kv_bytes = (size_t)lkp * LD * sizeof(bf16);
  const size_t p_bytes = (size_t)BQ * p_ld * sizeof(bf16);
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // staging, before K/V load
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sP = sK;                             // P overwrites K after Q K^T
  bf16* sV = reinterpret_cast<bf16*>(
      smem + (kv_bytes > p_bytes ? kv_bytes : p_bytes));
  float* sS = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(sV) + kv_bytes);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * BQ;
  const int col0 = blockIdx.y * HD;
  const int b = blockIdx.z;
  const bf16* qb = q + (size_t)b * Lq * D;
  const bf16* kb = k + (size_t)b * Lk * D;
  const bf16* vb = v + (size_t)b * Lk * D;

  // Q tile -> wmma fragments (rows >= Lq and pad columns zero).
  for (int i = tid; i < BQ * VEC; i += THREADS) {
    const int r = i / VEC;
    const int c = (i % VEC) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < Lq && c < HD) {
      val = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * D + col0 + c);
    }
    *reinterpret_cast<uint4*>(sQ + r * LD + c) = val;
  }
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[HDP / 16];
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    wmma::load_matrix_sync(qf[kk], sQ + warp * 16 * LD + kk * 16, LD);
  }
  __syncthreads();  // the staging area becomes K and V

  // The head's whole K and V (keys >= Lk and pad columns zero).
  for (int i = tid; i < lkp * VEC; i += THREADS) {
    const int r = i / VEC;
    const int c = (i % VEC) * 8;
    uint4 kval = make_uint4(0u, 0u, 0u, 0u);
    uint4 vval = kval;
    if (r < Lk && c < HD) {
      const size_t off = (size_t)r * D + col0 + c;
      kval = *reinterpret_cast<const uint4*>(kb + off);
      vval = *reinterpret_cast<const uint4*>(vb + off);
    }
    *reinterpret_cast<uint4*>(sK + r * LD + c) = kval;
    *reinterpret_cast<uint4*>(sV + r * LD + c) = vval;
  }
  __syncthreads();

  // S = Q K^T over every key: K is (kv, hd) row-major, i.e. K^T col-major.
  float* wS = sS + warp * 16 * f_ld;  // this warp's 16 x lkp scores
  for (int n = 0; n < lkp / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
      wmma::load_matrix_sync(kf, sK + n * 16 * LD + kk * 16, LD);
      wmma::mma_sync(acc, qf[kk], kf, acc);
    }
    wmma::store_matrix_sync(wS + n * 16, acc, f_ld, wmma::mem_row_major);
  }
  __syncthreads();  // every warp is done with K: P may overwrite it

  // Exact softmax, two lanes per row, each owning half of the lkp columns
  // (base-2 exponent, f32).  Lk >= 1, so every row max is finite.
  const int row = lane >> 1;
  const int half = lane & 1;
  const int nh = lkp / 2;
  float* srow = wS + row * f_ld + half * nh;
  float mx = -INFINITY;
  for (int j = 0; j < nh; ++j) {
    const float s = half * nh + j < Lk ? srow[j] * scale_log2 : -INFINITY;
    srow[j] = s;
    mx = fmaxf(mx, s);
  }
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  float sum = 0.f;
  for (int j = 0; j < nh; ++j) {
    const float p = exp2f(srow[j] - mx);  // padded keys: exp2(-inf) = 0
    srow[j] = p;
    sum += p;
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  const float inv = 1.f / sum;
  bf16* wP = sP + warp * 16 * p_ld;  // this warp's 16 x lkp probabilities
  bf16* prow = wP + row * p_ld + half * nh;
  for (int j = 0; j < nh; ++j) prow[j] = __float2bfloat16(srow[j] * inv);
  __syncwarp();

  // O = P V, one 16-column fragment at a time, staged through the warp's
  // score rows (f32) and written as 16-byte vectors: lane (row, half) owns
  // 8 columns; pad columns (hd 40: 40..47) are never written.
  const int gq = q0 + warp * 16 + row;
  bf16* dst = o + ((size_t)b * Lq + gq) * D + col0;
#pragma unroll
  for (int n = 0; n < HDP / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < lkp / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
      wmma::load_matrix_sync(pf, wP + kk * 16, p_ld);
      wmma::load_matrix_sync(vf, sV + kk * 16 * LD + n * 16, LD);
      wmma::mma_sync(acc, pf, vf, acc);
    }
    wmma::store_matrix_sync(wS, acc, f_ld, wmma::mem_row_major);
    __syncwarp();
    const int c = n * 16 + half * 8;
    if (gq < Lq && c < HD) {
      const float* orow = wS + row * f_ld + half * 8;
      __align__(16) bf16 tmp[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) tmp[j] = __float2bfloat16(orow[j]);
      *reinterpret_cast<uint4*>(dst + c) = *reinterpret_cast<const uint4*>(tmp);
    }
    __syncwarp();  // staging rows are rewritten by the next fragment
  }
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
  const dim3 grid((Lq + BQ - 1) / BQ, H, B);
  cross_short_kernel<HD><<<grid, THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), Lq, Lk, lkp, D,
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
