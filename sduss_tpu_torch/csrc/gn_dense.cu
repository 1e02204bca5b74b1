// Dense GroupNorm (+SiLU) for Hopper (sm_90a), NCHW, bf16 or float32:
// kernel K6.
//
// Replaces no TPU kernel: the JAX package's group_norm
// (sduss_tpu/models/layers.py) is plain jnp code that XLA fuses into about
// two passes over the tensor.  PyTorch runs the same code eagerly, as some
// eighteen launches (a float32 copy, two means, the moments and affine, a
// multiply, an add, SiLU, the cast back) moving ~52 bytes of device memory
// an element; this kernel does the work of every dense GroupNorm of the
// UNet and the VAE decoder in one launch or two.
//
// Function (that of ops/gn_dense.py group_norm_reference): for x
// (N, C, HW) in groups of C/G channels, optionally first
// x' = round_to_dtype(x + add[n, c]) (the ResnetBlock's time-embedding
// add, fused), then float32 moments E[x], E[x^2] - E[x]^2 clamped at 0 per
// (n, g), a = rstd * w_c, b = b_c - mean * a, y = act(x * a + b) in x's
// dtype.
//
// What bounds it on this card: device-memory bytes.  The least it can
// move is one read and one write of the tensor, 4 bytes an element in
// bf16 (8 in float32), at two to eight flops an element.  Two passes read
// the tensor twice: 6 bytes an element, 2/3 of the bound at best; L2
// (50 MB) returns part of the second read where the tensor, or the end of
// it that the first pass touched last, still lies there.
//
// In NCHW each (n, g) group is one contiguous run of L = (C/G) * HW
// elements.  Two designs, chosen by the wrapper from the shape
// (ops/gn_dense.py plan_cluster):
//
// Single read (every UNet shape: a group of at most 1 MB, 64 groups or
// more a launch): gn_cluster_kernel holds a group in the shared memory of
// one thread-block cluster of `cluster` blocks (1 to 16), each block a
// chunk of at most 64 KB.  A block loads its chunk once with 16-byte
// loads into shared memory, reducing (sum x, sum x^2) in float32 (each
// thread in order, then a shuffle butterfly, then the warps in order); the
// cluster exchanges its blocks' partials through distributed shared
// memory, every block summing them in rank order (so each computes the
// same moments), and each block writes act(x * a + b) from its shared
// copy.  4 bytes an element: the bound.  One launch.
//
// Two passes (the decoder's larger groups and one-image launches, an
// unaligned x or an HW that is not a multiple of a vector): the wrapper cuts every run into `spans` spans
// of `span_len` elements (a multiple of 16 bytes; ops/gn_dense.py
// plan_spans, a pure function of the shape) so that the grid has about
// two waves of resident blocks (four 512-thread blocks an SM); both
// kernels run one block a span.
//   (a) gn_stats_kernel: a block reads its span with 16-byte loads, four
//       in flight a thread, and reduces (sum x, sum x^2) in float32: each
//       thread in order, then a shuffle butterfly, then the warps in
//       order.  One float2 partial a span goes to scratch.
//   (b) gn_apply_kernel: a block sums its group's partials in span order,
//       folds mean, rstd and the affine into one (a, b) per channel of the
//       group (a table in shared memory), and writes act(x * a + b) with
//       16-byte loads and stores.  Blocks run in the reverse span order of
//       (a), so the first to run re-read what (a) read last, which L2 may
//       still hold.
// No atomics in either design: every sum is taken in a fixed order, so a
// call repeats bit for bit (the cache gate's decisions compare values of
// such outputs).
// The channel of an element is (offset in the group) / HW, by a
// multiply-shift with a divisor the wrapper precomputes.  The vector path
// needs x 16-byte aligned and HW a multiple of a vector (8 bf16, 4
// float32), so that no vector straddles two channels; anything else takes
// the scalar instantiation.  A group's offset is 64-bit; offsets inside a
// group are 32-bit (the wrapper refuses a sample of 2^31 elements or
// more).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

typedef __nv_bfloat16 bf16;

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;  // 16-byte loads a thread keeps in flight

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as PyTorch's cast
}

// n / d for 0 <= n < 2^31, with (mul, shift) from the wrapper's
// fast_divisor(d).
__device__ __forceinline__ int fast_div(int n, unsigned mul, int shift) {
  return (int)((__umulhi((unsigned)n, mul) + (unsigned)n) >> shift);
}

__device__ __forceinline__ float silu(float y) {
  return __fdividef(y, 1.f + __expf(-y));
}

// The block's (sum x, sum x^2), valid in thread 0: a shuffle butterfly in
// each warp, then the warps in order.  Every thread of the block calls it.
template <int NWARPS>
__device__ __forceinline__ float2 block_sums(float s, float ss,
                                             float (*red)[NWARPS]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  }
  if ((threadIdx.x & 31) == 0) {
    red[0][threadIdx.x >> 5] = s;
    red[1][threadIdx.x >> 5] = ss;
  }
  __syncthreads();
  float a = 0.f, b = 0.f;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < NWARPS; ++k) {
      a += red[0][k];
      b += red[1][k];
    }
  }
  return make_float2(a, b);
}

// (mean, rstd) of a group of L elements from its (sum x, sum x^2): the
// variance E[x^2] - E[x]^2 clamped at 0.
__device__ __forceinline__ float2 moments(float sum, float sumsq, int L,
                                          float eps) {
  const float mean = sum / (float)L;
  const float var = fmaxf(sumsq / (float)L - mean * mean, 0.f);
  return make_float2(mean, rsqrtf(var + eps));
}

// The group's channels c0 .. c0 + cpg - 1 folded with its moments:
// sA[i] = rstd * w_c, sB[i] = b_c - mean * sA[i]; weight and bias bf16, or
// float32 where w_f32.
__device__ __forceinline__ void fold_affine(const void* weight,
                                            const void* bias, int w_f32,
                                            int c0, int cpg, float mean,
                                            float rstd, float* sA,
                                            float* sB) {
  for (int i = threadIdx.x; i < cpg; i += blockDim.x) {
    const int c = c0 + i;
    const float wc = w_f32 ? static_cast<const float*>(weight)[c]
                           : __bfloat162float(
                                 static_cast<const bf16*>(weight)[c]);
    const float bc = w_f32 ? static_cast<const float*>(bias)[c]
                           : __bfloat162float(
                                 static_cast<const bf16*>(bias)[c]);
    const float a = rstd * wc;
    sA[i] = a;
    sB[i] = bc - mean * a;
  }
}

struct Shape {
  int C, G, HW, L, spans, span_len;
  unsigned hw_mul;
  int hw_shift;
};

// The block's group, sample and span: block b is span b % spans of group
// b / spans, groups numbered (n, g) as they lie in memory.
struct Where {
  int ng, n, g, s0, len;
};

__device__ __forceinline__ Where where(const Shape& sh, int blk) {
  Where w;
  w.ng = blk / sh.spans;
  const int sp = blk - w.ng * sh.spans;
  w.n = w.ng / sh.G;
  w.g = w.ng - w.n * sh.G;
  w.s0 = sp * sh.span_len;
  w.len = min(sh.span_len, sh.L - w.s0);
  return w;
}

template <typename T, bool VEC, bool ADD>
__global__ void __launch_bounds__(THREADS)
gn_stats_kernel(const T* __restrict__ x, const T* __restrict__ add,
                float2* __restrict__ part, Shape sh) {
  extern __shared__ float s_add[];  // ADD: the group's cpg add values
  __shared__ float red[2][WARPS];
  const Where w = where(sh, blockIdx.x);
  const int cpg = sh.C / sh.G;
  const int tid = threadIdx.x;
  if (ADD) {
    for (int i = tid; i < cpg; i += THREADS) {
      s_add[i] = to_f(add[(size_t)w.n * sh.C + w.g * cpg + i]);
    }
    __syncthreads();
  }
  const T* src = x + (size_t)w.ng * sh.L + w.s0;
  float s = 0.f, ss = 0.f;
  if (VEC) {
    constexpr int V = 16 / sizeof(T);
    const int nvec = w.len / V;
    for (int base = tid; base < nvec; base += THREADS * UNROLL) {
      uint4 raw[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = base + u * THREADS;
        raw[u] = i < nvec ? *reinterpret_cast<const uint4*>(src + i * V)
                          : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = base + u * THREADS;
        if (i < nvec) {
          const T* e = reinterpret_cast<const T*>(&raw[u]);
          const float av =
              ADD ? s_add[fast_div(w.s0 + i * V, sh.hw_mul, sh.hw_shift)]
                  : 0.f;
#pragma unroll
          for (int j = 0; j < V; ++j) {
            float v = to_f(e[j]);
            if (ADD) v = to_f(from_f<T>(v + av));
            s += v;
            ss = fmaf(v, v, ss);
          }
        }
      }
    }
  } else {
    for (int i = tid; i < w.len; i += THREADS) {
      float v = to_f(src[i]);
      if (ADD) {
        v = to_f(from_f<T>(
            v + s_add[fast_div(w.s0 + i, sh.hw_mul, sh.hw_shift)]));
      }
      s += v;
      ss = fmaf(v, v, ss);
    }
  }
  const float2 sums = block_sums<WARPS>(s, ss, red);
  if (tid == 0) part[blockIdx.x] = sums;
}

template <typename T, bool VEC, bool ADD, bool SILU>
__global__ void __launch_bounds__(THREADS)
gn_apply_kernel(const T* __restrict__ x, const T* __restrict__ add,
                const float2* __restrict__ part,
                const void* __restrict__ weight,
                const void* __restrict__ bias, int w_f32, float eps,
                T* __restrict__ out, Shape sh) {
  // sA, sB: the group's cpg folded (a, b); ADD: then its cpg add values
  extern __shared__ float tab[];
  __shared__ float s_mean, s_rstd;
  const Where w = where(sh, gridDim.x - 1 - blockIdx.x);
  const int cpg = sh.C / sh.G;
  const int tid = threadIdx.x;
  if (tid == 0) {
    const float2* p = part + (size_t)w.ng * sh.spans;
    float a = 0.f, b = 0.f;
    for (int k = 0; k < sh.spans; ++k) {
      a += p[k].x;
      b += p[k].y;
    }
    const float2 m = moments(a, b, sh.L, eps);
    s_mean = m.x;
    s_rstd = m.y;
  }
  __syncthreads();
  float* sA = tab;
  float* sB = tab + cpg;
  float* sAdd = tab + 2 * cpg;
  fold_affine(weight, bias, w_f32, w.g * cpg, cpg, s_mean, s_rstd, sA, sB);
  if (ADD) {
    for (int i = tid; i < cpg; i += THREADS) {
      sAdd[i] = to_f(add[(size_t)w.n * sh.C + w.g * cpg + i]);
    }
  }
  __syncthreads();
  const size_t off = (size_t)w.ng * sh.L + w.s0;
  const T* src = x + off;
  T* dst = out + off;
  if (VEC) {
    constexpr int V = 16 / sizeof(T);
    const int nvec = w.len / V;
    for (int base = tid; base < nvec; base += THREADS * UNROLL) {
      uint4 raw[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = base + u * THREADS;
        raw[u] = i < nvec ? *reinterpret_cast<const uint4*>(src + i * V)
                          : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = base + u * THREADS;
        if (i < nvec) {
          const int cl = fast_div(w.s0 + i * V, sh.hw_mul, sh.hw_shift);
          const float a = sA[cl], b = sB[cl];
          const float av = ADD ? sAdd[cl] : 0.f;
          const T* e = reinterpret_cast<const T*>(&raw[u]);
          uint4 o;
          T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            float v = to_f(e[j]);
            if (ADD) v = to_f(from_f<T>(v + av));
            float y = fmaf(v, a, b);
            if (SILU) y = silu(y);
            oe[j] = from_f<T>(y);
          }
          *reinterpret_cast<uint4*>(dst + i * V) = o;
        }
      }
    }
  } else {
    for (int i = tid; i < w.len; i += THREADS) {
      const int cl = fast_div(w.s0 + i, sh.hw_mul, sh.hw_shift);
      float v = to_f(src[i]);
      if (ADD) v = to_f(from_f<T>(v + sAdd[cl]));
      float y = fmaf(v, sA[cl], sB[cl]);
      if (SILU) y = silu(y);
      dst[i] = from_f<T>(y);
    }
  }
}

// The single-read design: one cluster of CS blocks a group, block `rank`
// its chunk [rank * chunk, min(L, (rank + 1) * chunk)) in shared memory
// (`chunk` a multiple of a vector; the vector path only).
constexpr int CLUSTER_THREADS = 256;

template <typename T, bool ADD, bool SILU>
__global__ void __launch_bounds__(CLUSTER_THREADS)
gn_cluster_kernel(const T* __restrict__ x, const T* __restrict__ add,
                  const void* __restrict__ weight,
                  const void* __restrict__ bias, int w_f32, float eps,
                  T* __restrict__ out, Shape sh, int chunk) {
  constexpr int V = 16 / sizeof(T);
  constexpr int CWARPS = CLUSTER_THREADS / 32;
  // the chunk, then the group's folded (a, b) and (ADD) add values
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ float2 part;
  __shared__ float red[2][CWARPS];
  __shared__ float s_mean, s_rstd;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int ng = blockIdx.x / cs;
  const int n = ng / sh.G, g = ng - n * sh.G;
  const int cpg = sh.C / sh.G;
  const int s0 = rank * chunk;
  const int nvec = max(0, min(chunk, sh.L - s0)) / V;
  T* buf = reinterpret_cast<T*>(dyn);
  float* sA = reinterpret_cast<float*>(dyn + (size_t)chunk * sizeof(T));
  float* sB = sA + cpg;
  float* sAdd = sA + 2 * cpg;
  const int tid = threadIdx.x;
  if (ADD) {
    for (int i = tid; i < cpg; i += CLUSTER_THREADS) {
      sAdd[i] = to_f(add[(size_t)n * sh.C + g * cpg + i]);
    }
    __syncthreads();
  }
  const T* src = x + (size_t)ng * sh.L + s0;
  float s = 0.f, ss = 0.f;
  for (int base = tid; base < nvec; base += CLUSTER_THREADS * UNROLL) {
    uint4 raw[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = base + u * CLUSTER_THREADS;
      raw[u] = i < nvec ? *reinterpret_cast<const uint4*>(src + i * V)
                        : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = base + u * CLUSTER_THREADS;
      if (i < nvec) {
        T* e = reinterpret_cast<T*>(&raw[u]);
        const float av =
            ADD ? sAdd[fast_div(s0 + i * V, sh.hw_mul, sh.hw_shift)] : 0.f;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          if (ADD) e[j] = from_f<T>(to_f(e[j]) + av);
          const float v = to_f(e[j]);
          s += v;
          ss = fmaf(v, v, ss);
        }
        *reinterpret_cast<uint4*>(buf + i * V) = raw[u];
      }
    }
  }
  const float2 sums = block_sums<CWARPS>(s, ss, red);
  if (tid == 0) part = sums;
  cluster.sync();
  if (tid == 0) {
    float a = 0.f, b = 0.f;
    for (int r = 0; r < cs; ++r) {
      const float2 p = *cluster.map_shared_rank(&part, r);
      a += p.x;
      b += p.y;
    }
    const float2 m = moments(a, b, sh.L, eps);
    s_mean = m.x;
    s_rstd = m.y;
  }
  // arrive now, wait at the end: no block leaves (freeing `part`) before
  // every block of the cluster has read it
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  __syncthreads();
  fold_affine(weight, bias, w_f32, g * cpg, cpg, s_mean, s_rstd, sA, sB);
  __syncthreads();
  T* dst = out + (size_t)ng * sh.L + s0;
  for (int i = tid; i < nvec; i += CLUSTER_THREADS) {
    uint4 raw = *reinterpret_cast<const uint4*>(buf + i * V);
    const int cl = fast_div(s0 + i * V, sh.hw_mul, sh.hw_shift);
    const float a = sA[cl], b = sB[cl];
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float y = fmaf(to_f(e[j]), a, b);
      if (SILU) y = silu(y);
      e[j] = from_f<T>(y);
    }
    *reinterpret_cast<uint4*>(dst + i * V) = raw;
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

struct Args {
  const void* x;
  const void* add;
  const void* weight;
  const void* bias;
  int w_f32;
  float eps;
  void* part;
  void* out;
  int blocks;
  int act_silu;
  Shape sh;
};

template <typename T, bool VEC, bool ADD>
int run(const Args& a, cudaStream_t stream) {
  const int cpg = a.sh.C / a.sh.G;
  const T* x = static_cast<const T*>(a.x);
  const T* add = static_cast<const T*>(a.add);
  float2* part = static_cast<float2*>(a.part);
  gn_stats_kernel<T, VEC, ADD>
      <<<a.blocks, THREADS, ADD ? cpg * sizeof(float) : 0, stream>>>(
          x, add, part, a.sh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (ADD ? 3 : 2) * cpg * sizeof(float);
  if (a.act_silu) {
    gn_apply_kernel<T, VEC, ADD, true><<<a.blocks, THREADS, smem, stream>>>(
        x, add, part, a.weight, a.bias, a.w_f32, a.eps,
        static_cast<T*>(a.out), a.sh);
  } else {
    gn_apply_kernel<T, VEC, ADD, false><<<a.blocks, THREADS, smem, stream>>>(
        x, add, part, a.weight, a.bias, a.w_f32, a.eps,
        static_cast<T*>(a.out), a.sh);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int run_typed(const Args& a, int vec, cudaStream_t stream) {
  const bool has_add = a.add != nullptr;
  if (vec) {
    return has_add ? run<T, true, true>(a, stream)
                   : run<T, true, false>(a, stream);
  }
  return has_add ? run<T, false, true>(a, stream)
                 : run<T, false, false>(a, stream);
}

template <typename T, bool ADD, bool SILU>
int launch_cluster(const Args& a, int cs, int chunk, cudaStream_t stream) {
  const int cpg = a.sh.C / a.sh.G;
  const size_t smem =
      (size_t)chunk * sizeof(T) + (ADD ? 3 : 2) * cpg * sizeof(float);
  auto kern = gn_cluster_kernel<T, ADD, SILU>;
  // both attributes act on the current device (the wrapper's)
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && cs > 8) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.blocks);
  cfg.blockDim = dim3(CLUSTER_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(a.x),
                           static_cast<const T*>(a.add), a.weight, a.bias,
                           a.w_f32, a.eps, static_cast<T*>(a.out), a.sh,
                           chunk);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <typename T>
int run_cluster(const Args& a, int cs, int chunk, cudaStream_t stream) {
  const bool has_add = a.add != nullptr;
  if (a.act_silu) {
    return has_add ? launch_cluster<T, true, true>(a, cs, chunk, stream)
                   : launch_cluster<T, false, true>(a, cs, chunk, stream);
  }
  return has_add ? launch_cluster<T, true, false>(a, cs, chunk, stream)
                 : launch_cluster<T, false, false>(a, cs, chunk, stream);
}

}  // namespace

// x, out: contiguous (N, C, HW), bf16 (x_f32 = 0) or float32 (x_f32 = 1);
// add: null or contiguous (N, C) in x's dtype; weight, bias: (C,) bf16
// (w_f32 = 0) or float32 (w_f32 = 1); part: float32 scratch of
// 2 * N * G * spans; C % G == 0, C / G <= 2048 (the apply kernel's
// dynamic tables, three floats a channel with the add, and its 8 bytes of
// static shared memory must fit the 48 KB a launch has without an opt-in),
// (C / G) * HW < 2^31, span_len a multiple of 8 and
// (spans - 1) * span_len < (C / G) * HW <= spans * span_len; vec = 1 only
// where x and out are 16-byte aligned and HW is a multiple of 16 bytes'
// elements; (hw_mul, hw_shift) divide by HW (fast_divisor).  act_silu:
// 1 = SiLU, 0 = none.  Launches the two kernels on `stream`; returns
// cudaGetLastError() (0 = launched).
extern "C" int sduss_gn_dense(const void* x, const void* add,
                              const void* weight, const void* bias, int w_f32,
                              void* part, void* out, int N, int C, int HW,
                              int G, int spans, int span_len, int x_f32,
                              int vec, int act_silu, float eps,
                              unsigned hw_mul, int hw_shift, void* stream) {
  if (N < 1 || C < 1 || HW < 1 || G < 1 || C % G != 0 || spans < 1 ||
      span_len < 1 || C / G > 2048) {
    return (int)cudaErrorInvalidValue;
  }
  const long long L = (long long)(C / G) * HW;
  const long long blocks = (long long)N * G * spans;
  if (L >= (1LL << 31) || blocks >= (1LL << 31) ||
      (long long)(spans - 1) * span_len >= L ||
      (long long)spans * span_len < L) {
    return (int)cudaErrorInvalidValue;
  }
  Args a;
  a.x = x;
  a.add = add;
  a.weight = weight;
  a.bias = bias;
  a.w_f32 = w_f32;
  a.eps = eps;
  a.part = part;
  a.out = out;
  a.blocks = (int)blocks;
  a.act_silu = act_silu;
  a.sh = Shape{C, G, HW, (int)L, spans, span_len, hw_mul, hw_shift};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_f32 ? run_typed<float>(a, vec, st) : run_typed<bf16>(a, vec, st);
}

// The single-read design.  As sduss_gn_dense, without the scratch and the
// span plan: x and out 16-byte aligned and HW a multiple of 16 bytes'
// elements (the vector path); `cluster` in {1, 2, 4, 8, 16} blocks a
// group, each a chunk of ceil(L / cluster) elements rounded up to a
// vector, at most MAX_CHUNK_BYTES.  One launch on `stream`; returns
// cudaGetLastError() (0 = launched).
extern "C" int sduss_gn_dense_cluster(const void* x, const void* add,
                                      const void* weight, const void* bias,
                                      int w_f32, void* out, int N, int C,
                                      int HW, int G, int cluster, int x_f32,
                                      int act_silu, float eps,
                                      unsigned hw_mul, int hw_shift,
                                      void* stream) {
  constexpr long long MAX_CHUNK_BYTES = 64 * 1024;
  const int item = x_f32 ? 4 : 2;
  const int vec = 16 / item;
  if (N < 1 || C < 1 || HW < 1 || G < 1 || C % G != 0 || C / G > 2048 ||
      HW % vec != 0 || cluster < 1 || cluster > 16 ||
      (cluster & (cluster - 1)) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long L = (long long)(C / G) * HW;
  const long long chunk = (L + cluster - 1) / cluster;
  const long long chunk_v = (chunk + vec - 1) / vec * vec;
  const long long blocks = (long long)N * G * cluster;
  if (L >= (1LL << 31) || blocks >= (1LL << 31) ||
      chunk_v * item > MAX_CHUNK_BYTES) {
    return (int)cudaErrorInvalidValue;
  }
  Args a;
  a.x = x;
  a.add = add;
  a.weight = weight;
  a.bias = bias;
  a.w_f32 = w_f32;
  a.eps = eps;
  a.part = nullptr;
  a.out = out;
  a.blocks = (int)blocks;
  a.act_silu = act_silu;
  a.sh = Shape{C, G, HW, (int)L, 1, (int)L, hw_mul, hw_shift};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_f32 ? run_cluster<float>(a, cluster, (int)chunk_v, st)
               : run_cluster<bf16>(a, cluster, (int)chunk_v, st);
}
