// Fused per-image GroupNorm affine + SiLU + 1-cell halo write for Hopper
// (sm_90a), bf16 in/out, NCHW.
//
// Replaces sduss_tpu/ops/gn_halo.py::_kernel (the Pallas TPU kernel behind
// gn_silu_halo_pallas, kernel K4).  Input: a patch batch x (P, C, s, s),
// contiguous NCHW, the per-(image, group) float32 moments mean and rstd
// (I, G) and the GroupNorm affine weight and bias (C, bf16 like the
// model's parameters).  Output:
// (P, C, s+2, s+2), contiguous NCHW -- exactly what the following 3x3
// convolution reads with padding 0, so no copy sits between the two.  The
// centre is act(x*a + b) of the patch itself, with a = rstd*weight and
// b = bias - mean*a of the patch's image and channel; the 1-cell border is
// act(x*a + b) of the neighbouring patches' edge rows, columns and corners
// (neighbors[p] = up, down, left, right, ul, ur, dl, dr), and 0 where the
// neighbour is -1 (an image border).  A neighbour always belongs to the
// same image, so one (a, b) serves the whole output plane.
//
// What bounds it on this card: two flops per element against four bytes
// (a bf16 read and a bf16 write), so device-memory bytes: at SDXL's
// (P, C, s) = (128, 320, 32) it reads 84 MB and writes 95 MB, ~53 us at
// 3.35 TB/s.  The TPU kernel's reason to exist carries over: one pass
// writes the conv-ready tile, where the unfused composition materializes
// the normalized tensor, gathers its halo and concatenates (three passes).
//
// Design: a block owns one patch and a run of consecutive channels, whose
// output planes are one contiguous run of memory.  Blocks are numbered
// channel-run-fastest, so consecutive blocks read and write consecutive
// memory, and the planes of the neighbouring patches p-1 and p+1 (left
// and right within a patch row), whose edges a block reads, are read by
// blocks close in time; numbering them patch-fastest measured 1-3%
// slower (scripts/k4_block_order.py, PERF.md).  In its setup the block
// reads the patch's image id and 8 neighbours once and folds (a, b) for
// each of its channels into shared memory.  It then builds its output run
// in shared memory: the centre with 16-byte loads (a plane starts at a
// multiple of s*s*2 bytes, and s*s is a multiple of 8 at every templated
// side), the halo's up and down rows with 16-byte loads where s >= 8, its
// columns (strided) and corners with 2-byte loads, FMA and SiLU applied
// as each value lands.  Finally it copies the run out with 16-byte
// stores: the shared run starts at the same offset modulo 16 bytes as its
// place in the output, so only a head and a tail of at most 7 elements
// are scalar.  The side is a template constant for s = 4, 8, 16, 32
// (SD-1.5's level 3 and SDXL's three levels), so the index math is
// shifts; any other side takes the runtime-side instantiation.  All
// offsets are 32-bit (the wrapper refuses tensors of 2^31 elements or
// more).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int THREADS = 256;
constexpr int RUN_BYTES = 16384;  // output bytes a block aims to own
constexpr int MAX_RUN = 256;      // channels a block owns at most
constexpr int MIN_BLOCKS = 528;   // 4 blocks per SM of an H100, at least

__device__ __forceinline__ float apply_act(float y, int act_silu) {
  return act_silu ? y / (1.f + __expf(-y)) : y;
}

// S > 0: compile-time plane side; S == 0: runtime side `s_rt`.
template <int S>
__global__ void __launch_bounds__(THREADS)
gn_halo_kernel(const bf16* __restrict__ x, const int* __restrict__ image_id,
               const int* __restrict__ neighbors,
               const float* __restrict__ mean, const float* __restrict__ rstd,
               const bf16* __restrict__ weight, const bf16* __restrict__ bias,
               bf16* __restrict__ out, int P, int C, int s_rt, int G,
               int run, int act_silu) {
  const int s = S > 0 ? S : s_rt;
  const int w = s + 2;
  const int plane_in = s * s;
  const int plane_out = w * w;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float sA[MAX_RUN], sB[MAX_RUN];
  __shared__ int sNb[8];

  const int runs = (C + run - 1) / run;  // channel-run-fastest order
  const int p = blockIdx.x / runs;
  const int c0 = (blockIdx.x % runs) * run;
  const int nc = min(run, C - c0);
  const int tid = threadIdx.x;
  const int dst0 = (p * C + c0) * plane_out;  // first output element
  const int pad = dst0 & 7;  // the shared run's offset: same 16-B phase
  bf16* tile = reinterpret_cast<bf16*>(smem) + pad;

  if (tid < 8) sNb[tid] = neighbors[p * 8 + tid];
  {
    const int img = image_id[p];
    const int cpg = C / G;
    for (int i = tid; i < nc; i += THREADS) {
      const int c = c0 + i;
      const int g = img * G + c / cpg;
      const float a = rstd[g] * __bfloat162float(weight[c]);
      sA[i] = a;
      sB[i] = __bfloat162float(bias[c]) - mean[g] * a;
    }
  }
  __syncthreads();

  // Centre: 8 consecutive source elements a thread, one 16-byte load.
  const bf16* src = x + (p * C + c0) * plane_in;
  const int vec_per_plane = plane_in / 8;
  if (S > 0) {
    for (int i = tid; i < nc * vec_per_plane; i += THREADS) {
      const int pl = i / vec_per_plane;
      const int e0 = (i - pl * vec_per_plane) * 8;
      const uint4 raw = *reinterpret_cast<const uint4*>(src + i * 8);
      const bf16* vals = reinterpret_cast<const bf16*>(&raw);
      const float a = sA[pl], b = sB[pl];
      bf16* dst = tile + pl * plane_out;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int e = e0 + j;
        const int r = e / s, c = e - r * s;
        dst[(r + 1) * w + c + 1] = __float2bfloat16(
            apply_act(__bfloat162float(vals[j]) * a + b, act_silu));
      }
    }
  } else {
    for (int i = tid; i < nc * plane_in; i += THREADS) {
      const int pl = i / plane_in;
      const int e = i - pl * plane_in;
      const int r = e / s, c = e - r * s;
      tile[pl * plane_out + (r + 1) * w + c + 1] = __float2bfloat16(
          apply_act(__bfloat162float(src[i]) * sA[pl] + sB[pl], act_silu));
    }
  }

  // Halo rows: the up row (the last row of the patch above) and the down
  // row (the first row of the patch below); 16-byte loads where s is a
  // templated multiple of 8 (a row then starts 16-byte aligned).  0 at an
  // image border.
  constexpr int RV = S >= 8 && S % 8 == 0 ? S / 8 : 0;  // vectors a row
  if (RV > 0) {
    for (int i = tid; i < nc * 2 * RV; i += THREADS) {
      const int pl = i / (2 * RV);
      const int r = i - pl * 2 * RV;
      const int down = r >= RV;
      const int v = r - down * RV;
      const int nb = sNb[down];
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (nb >= 0) {
        raw = *reinterpret_cast<const uint4*>(
            x + (nb * C + c0 + pl) * plane_in + (down ? 0 : s - 1) * s +
            v * 8);
      }
      const bf16* vals = reinterpret_cast<const bf16*>(&raw);
      const float a = sA[pl], b = sB[pl];
      bf16* dst = tile + pl * plane_out + (down ? s + 1 : 0) * w + 1 + v * 8;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        dst[j] = __float2bfloat16(
            nb < 0 ? 0.f
                   : apply_act(__bfloat162float(vals[j]) * a + b, act_silu));
      }
    }
  }
  // The rest of the ring, one cell a thread: the rows where s is not a
  // templated multiple of 8, the left column (the last column of the patch
  // left), the right column (the first column of the patch right) and the
  // corners ul, ur, dl, dr.
  const int rows = RV > 0 ? 0 : 2 * s;  // row cells done above
  const int ring = rows + 2 * s + 4;
  for (int i = tid; i < nc * ring; i += THREADS) {
    const int pl = i / ring;
    int e = i - pl * ring;
    int nb, sy, sx, oy, ox;
    if (e < rows) {  // 0..s-1 up, s..2s-1 down
      const int down = e >= s;
      const int j = e - down * s;
      nb = sNb[down]; sy = down ? 0 : s - 1; sx = j;
      oy = down ? s + 1 : 0; ox = j + 1;
    } else if ((e -= rows) < 2 * s) {  // 0..s-1 left, s..2s-1 right
      const int right = e >= s;
      const int j = e - right * s;
      nb = sNb[2 + right]; sy = j; sx = right ? 0 : s - 1;
      oy = j + 1; ox = right ? s + 1 : 0;
    } else {
      const int j = e - 2 * s;
      nb = sNb[4 + j];
      sy = j < 2 ? s - 1 : 0;
      sx = j & 1 ? 0 : s - 1;
      oy = j < 2 ? 0 : s + 1;
      ox = j & 1 ? s + 1 : 0;
    }
    float r = 0.f;
    if (nb >= 0) {
      const float v = __bfloat162float(
          x[(nb * C + c0 + pl) * plane_in + sy * s + sx]);
      r = apply_act(v * sA[pl] + sB[pl], act_silu);
    }
    tile[pl * plane_out + oy * w + ox] = __float2bfloat16(r);
  }
  __syncthreads();

  // Out: scalar head up to the first 16-byte boundary, 16-byte vectors,
  // scalar tail.
  const int n = nc * plane_out;
  const int head = min((8 - pad) & 7, n);
  const int n_vec = (n - head) / 8;
  bf16* dst = out + dst0;
  for (int i = tid; i < n_vec; i += THREADS) {
    *reinterpret_cast<uint4*>(dst + head + i * 8) =
        *reinterpret_cast<const uint4*>(tile + head + i * 8);
  }
  const int tail0 = head + n_vec * 8;
  if (tid < head) dst[tid] = tile[tid];
  if (tid < n - tail0) dst[tail0 + tid] = tile[tail0 + tid];
}

template <int S>
int launch(const void* x, const void* image_id, const void* neighbors,
           const void* mean, const void* rstd, const void* weight,
           const void* bias, void* out, int P, int C, int s, int G,
           int act_silu, void* stream) {
  const int plane_bytes = (s + 2) * (s + 2) * (int)sizeof(bf16);
  // Channels a block: about RUN_BYTES of output, fewer where that would
  // leave under MIN_BLOCKS blocks (SD-1.5's s = 4).
  const int spread = (P * C + MIN_BLOCKS - 1) / MIN_BLOCKS;
  int run = RUN_BYTES / plane_bytes;
  run = run < spread ? run : spread;
  run = run < 1 ? 1 : (run > MAX_RUN ? MAX_RUN : run);
  run = run < C ? run : C;
  const int runs = (C + run - 1) / run;
  run = (C + runs - 1) / runs;  // even runs
  const size_t smem = (size_t)run * plane_bytes + 16;
  cudaError_t err = cudaFuncSetAttribute(
      gn_halo_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  gn_halo_kernel<S><<<(unsigned)(P * runs), THREADS, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const int*>(image_id),
      static_cast<const int*>(neighbors), static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<const bf16*>(weight),
      static_cast<const bf16*>(bias), static_cast<bf16*>(out), P, C, s, G,
      run, act_silu);
  return (int)cudaGetLastError();
}

}  // namespace

// x: contiguous bf16 (P, C, s, s); image_id: int32 (P,); neighbors: int32
// (P, 8); mean, rstd: float32 (I, G) with C % G == 0; weight, bias: bf16
// (C,); out: contiguous bf16 (P, C, s+2, s+2); P*C*(s+2)^2 < 2^31.
// act_silu: 1 = SiLU, 0 = none.
// Launches on `stream`, returns cudaGetLastError() (0 = launched).
extern "C" int sduss_gn_silu_halo(const void* x, const void* image_id,
                                  const void* neighbors, const void* mean,
                                  const void* rstd, const void* weight,
                                  const void* bias, void* out, int P, int C,
                                  int s, int G, int act_silu, void* stream) {
  if (P < 1 || C < 1 || s < 1 || G < 1 || C % G != 0) {
    return (int)cudaErrorInvalidValue;
  }
  switch (s) {
    case 32:
      return launch<32>(x, image_id, neighbors, mean, rstd, weight, bias, out,
                        P, C, s, G, act_silu, stream);
    case 16:
      return launch<16>(x, image_id, neighbors, mean, rstd, weight, bias, out,
                        P, C, s, G, act_silu, stream);
    case 8:
      return launch<8>(x, image_id, neighbors, mean, rstd, weight, bias, out,
                       P, C, s, G, act_silu, stream);
    case 4:
      return launch<4>(x, image_id, neighbors, mean, rstd, weight, bias, out,
                       P, C, s, G, act_silu, stream);
    default:
      return launch<0>(x, image_id, neighbors, mean, rstd, weight, bias, out,
                       P, C, s, G, act_silu, stream);
  }
}
