// Fused per-image GroupNorm affine + SiLU + 1-cell halo write for Hopper
// (sm_90a), bf16 in/out, NCHW.
//
// Replaces sduss_tpu/ops/gn_halo.py::_kernel (the Pallas TPU kernel behind
// gn_silu_halo_pallas, kernel K4).  Input: a patch batch x (P, C, s, s),
// contiguous NCHW, and per-(image, channel) float32 tables A = rstd*gamma,
// B = beta - mean*A (the group statistics folded outside, as the TPU kernel
// folds them).  Output: (P, C, s+2, s+2), contiguous NCHW — exactly what the
// following 3x3 convolution reads with padding 0, so no copy sits between
// the two.  The centre is act(x*A + B) of the patch itself; the 1-cell
// border is act(x*A + B) of the neighbouring patches' edge rows, columns and
// corners (neighbors[p] = up, down, left, right, ul, ur, dl, dr), and 0
// where the neighbour is -1 (an image border).  A patch is normalized with
// its own image's A/B; a neighbour always belongs to the same image.
//
// What bounds it on this card: two flops per element against four bytes
// (a bf16 read and a bf16 write), so device-memory bytes: at SDXL's
// (P, C, s) = (128, 320, 32) it reads 84 MB and writes 95 MB, ~53 us at
// 3.35 TB/s.  The TPU kernel's reason to exist carries over: one pass
// writes the conv-ready tile, where the unfused composition materializes
// the normalized tensor, gathers its halo and concatenates (three passes).
//
// Design (simple first): a block owns whole output planes (one (p, c)
// plane of (s+2)^2 elements, or several when s is small, so a block has
// ~1000 elements of work).  It first resolves, per plane, A/B and the
// base offsets of the 9 source planes (itself + 8 neighbours, -1 = zero
// fill) into shared memory; then its threads walk the output elements in
// order (coalesced 2-byte stores; centre loads coalesced along rows, edge
// columns strided).  The plane side is a template constant for SDXL's
// s = 32/16/8, so index math is shifts and multiplies.  16-byte vectors and
// a channels-last layout are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int THREADS = 256;
constexpr int MAX_PLANES = 16;  // planes per block at the smallest s

struct PlaneInfo {
  long long src[9];  // element offset of each source plane, -1 = zero fill
  float a, b;
};

__device__ __forceinline__ float apply_act(float y, int act_silu) {
  return act_silu ? y / (1.f + __expf(-y)) : y;
}

// S > 0: compile-time plane side; S == 0: runtime side `s_rt`.
template <int S>
__global__ void __launch_bounds__(THREADS)
gn_halo_kernel(const bf16* __restrict__ x, const int* __restrict__ image_id,
               const int* __restrict__ neighbors, const float* __restrict__ A,
               const float* __restrict__ B, bf16* __restrict__ out, int P,
               int C, int s_rt, int planes_per_block, int act_silu) {
  const int s = S > 0 ? S : s_rt;
  const int w = s + 2;
  const int elems = w * w;
  __shared__ PlaneInfo info[MAX_PLANES];

  const long long plane0 = (long long)blockIdx.x * planes_per_block;
  const long long n_planes = (long long)P * C;
  const long long plane_sz = (long long)s * s;
  if (threadIdx.x < planes_per_block) {
    const long long plane = plane0 + threadIdx.x;
    if (plane < n_planes) {
      const int p = (int)(plane / C);
      const int c = (int)(plane % C);
      const int img = image_id[p];
      PlaneInfo& pi = info[threadIdx.x];
      pi.a = A[(size_t)img * C + c];
      pi.b = B[(size_t)img * C + c];
      pi.src[0] = ((long long)p * C + c) * plane_sz;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int nb = neighbors[p * 8 + k];
        pi.src[1 + k] = nb < 0 ? -1 : ((long long)nb * C + c) * plane_sz;
      }
    }
  }
  __syncthreads();

  const long long left = n_planes - plane0;
  const long long planes_here =
      left < planes_per_block ? left : (long long)planes_per_block;
  const int total = (int)planes_here * elems;
  bf16* dst = out + plane0 * elems;
  for (int i = threadIdx.x; i < total; i += THREADS) {
    const int pl = i / elems;
    const int e = i - pl * elems;
    const int oy = e / w;
    const int ox = e - oy * w;
    // source coordinates: -1 and s fall in the neighbours, wrapped
    const int y = oy - 1, xx = ox - 1;
    const int dy = y < 0 ? -1 : (y >= s ? 1 : 0);
    const int dx = xx < 0 ? -1 : (xx >= s ? 1 : 0);
    // (dy, dx) -> 0 centre, 1 up, 2 down, 3 left, 4 right, 5 ul, 6 ur,
    // 7 dl, 8 dr (the neighbour order of the patch metadata, shifted by 1)
    int k;
    if (dy == 0) {
      k = dx == 0 ? 0 : (dx < 0 ? 3 : 4);
    } else if (dx == 0) {
      k = dy < 0 ? 1 : 2;
    } else {
      k = dy < 0 ? (dx < 0 ? 5 : 6) : (dx < 0 ? 7 : 8);
    }
    const PlaneInfo& pi = info[pl];
    const long long base = pi.src[k];
    float r = 0.f;
    if (base >= 0) {
      const int sy = y < 0 ? s - 1 : (y >= s ? 0 : y);
      const int sx = xx < 0 ? s - 1 : (xx >= s ? 0 : xx);
      const float v = __bfloat162float(x[base + sy * s + sx]);
      r = apply_act(v * pi.a + pi.b, act_silu);
    }
    dst[i] = __float2bfloat16(r);
  }
}

template <int S>
int launch(const void* x, const void* image_id, const void* neighbors,
           const void* A, const void* B, void* out, int P, int C, int s,
           int act_silu, void* stream) {
  const int elems = (s + 2) * (s + 2);
  int ppb = (4 * THREADS) / elems;
  ppb = ppb < 1 ? 1 : (ppb > MAX_PLANES ? MAX_PLANES : ppb);
  const long long n_planes = (long long)P * C;
  const long long blocks = (n_planes + ppb - 1) / ppb;
  gn_halo_kernel<S><<<(unsigned)blocks, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const int*>(image_id),
      static_cast<const int*>(neighbors), static_cast<const float*>(A),
      static_cast<const float*>(B), static_cast<bf16*>(out), P, C, s, ppb,
      act_silu);
  return (int)cudaGetLastError();
}

}  // namespace

// x: contiguous bf16 (P, C, s, s); image_id: int32 (P,); neighbors: int32
// (P, 8); A, B: float32 (I, C); out: contiguous bf16 (P, C, s+2, s+2).
// act_silu: 1 = SiLU, 0 = none.  Launches on `stream`, returns
// cudaGetLastError() (0 = launched).
extern "C" int sduss_gn_silu_halo(const void* x, const void* image_id,
                                  const void* neighbors, const void* A,
                                  const void* B, void* out, int P, int C,
                                  int s, int act_silu, void* stream) {
  switch (s) {
    case 32:
      return launch<32>(x, image_id, neighbors, A, B, out, P, C, s, act_silu,
                        stream);
    case 16:
      return launch<16>(x, image_id, neighbors, A, B, out, P, C, s, act_silu,
                        stream);
    case 8:
      return launch<8>(x, image_id, neighbors, A, B, out, P, C, s, act_silu,
                       stream);
    default:
      return launch<0>(x, image_id, neighbors, A, B, out, P, C, s, act_silu,
                       stream);
  }
}
