// Fused affine-free InstanceNorm3d + activation, forward and backward, for
// Hopper (sm_90a).
//
// Replaces the TPU Pallas kernels of mra_gan_tpu/ops/pallas/instance_norm.py:
//   _sum_kernel       (:86)  per-(n, c) statistics  -> stats_kernel + finalize_kernel
//   _apply_kernel     (:100) normalise + activation -> apply_kernel
//   _bwd_sum_kernel   (:137) sums of g' and g'z     -> bwd_stats_kernel + bwd_finalize_kernel
//   _bwd_apply_kernel (:155) the input gradient     -> bwd_apply_kernel
// y = act((x - mean) * rsqrt(var + eps)), act in {none, relu, leaky_relu, tanh},
// with the variance CENTRED (as mra_gan_tpu/ops/norm.py:_in_fwd_core), not the
// Pallas kernel's E[x^2] - E[x]^2, which cancels when |mean| >> std.
//
// Layout: x is NDHWC in memory (a torch NCDHW tensor in channels_last_3d), so
// the C channels of one voxel are contiguous. Every thread owns VEC
// consecutive channels of a voxel: one 16-byte load or store (8 bf16 or 4 f32).
//
// Bound: memory. The norm does a few flops per element (~1 flop per byte in
// bf16, against the H100's ~295 bf16 flops per byte), so only the bytes
// count. The design keeps it to three passes over the big tensor:
//   1. stats_kernel reads x once. The TPU walks depth tiles in order and
//      carries the sum in one VMEM block; here blocks run in no order, so
//      the grid is (S segments, N samples, channel chunks) with S chosen by
//      the wrapper to fill the 132 SMs several times over. Each block walks
//      one contiguous voxel segment for its channels, keeps a per-thread
//      Welford (count, mean, M2) in f32, merges its threads with Chan's
//      formula in shared memory and writes (N, S, C) f32 partials.
//   2. finalize_kernel merges the S partials per (n, c) (Chan again) into
//      mean and rstd, (N, C) f32. It touches only the partials.
//   3. apply_kernel reads x once more and writes y once, with the thread's
//      mean and rstd held in registers; z is formed in f32 and rounded once
//      to x's dtype.
// Offsets are int64: a batch-8 full-volume tensor passes 2^31 elements.
//
// Backward (the analytic VJP, mra_gan_tpu/ops/norm.py:_in_vjp_bwd):
//   g' = g * act'(z),  dx = rstd * (g' - mean(g') - z * mean(g' z)),
// with z recomputed from x and the saved (mean, rstd): no activation is
// stored. Bound: memory again, x + g in and dx out at the least, and two
// passes over x and g as on the TPU:
//   4. bwd_stats_kernel reads x and g once on the forward's (S, N, chunk)
//      grid and writes (N, S, C) f32 partial sums of g' and g'z (plain sums:
//      nothing cancels here the way E[x^2] - E[x]^2 does);
//   5. bwd_finalize_kernel adds the S partials per (n, c) and divides by V;
//   6. bwd_apply_kernel reads x and g again and writes dx, all in f32 and
//      rounded once to g's dtype (the Pallas form, not the XLA one, which
//      rounds at every step).
// z is formed by one function, normalize(), in the forward's apply_kernel
// and in both backward kernels, so a relu or leaky_relu mask at z ~ 0 is
// the same in the two passes; act'(z) is taken at z >= 0, as in JAX.
//
// Plain C interface for ctypes; every launch goes on the caller's stream and
// returns cudaGetLastError() so that the wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;   // stats and apply blocks (the wrapper's _THREADS)
constexpr int kFinX = 32;       // finalize: channels per block
constexpr int kFinY = 32;       // finalize: segment lanes per block

enum { DT_F32 = 0, DT_BF16 = 1 };
enum { ACT_NONE = 0, ACT_RELU = 1, ACT_LEAKY_RELU = 2, ACT_TANH = 3 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// VEC consecutive channels of one voxel; a single 16-byte access when
// VEC * sizeof(T) == 16 (the wrapper checks the alignment).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// First voxel of segment s when V voxels are split into S segments.
__device__ __forceinline__ int64_t seg_begin(int64_t s, int64_t V, int64_t S) {
  return s * V / S;
}

// Chan et al.: fold (nb, mb, qb) into (na, ma, qa).
__device__ __forceinline__ void chan_merge(float& na, float& ma, float& qa,
                                           float nb, float mb, float qb) {
  const float n = na + nb;
  const float wb = nb / n;
  const float d = mb - ma;
  ma += d * wb;
  qa += qb + d * d * na * wb;
  na = n;
}

// The one expression for z, forward and backward.
__device__ __forceinline__ float normalize(float x, float mu, float rs) {
  return (x - mu) * rs;
}

template <int ACT>
__device__ __forceinline__ float activate(float z, float slope) {
  if constexpr (ACT == ACT_RELU) return fmaxf(z, 0.f);
  if constexpr (ACT == ACT_LEAKY_RELU) return z >= 0.f ? z : slope * z;
  if constexpr (ACT == ACT_TANH) return tanhf(z);
  return z;
}

// act'(z), from the pre-activation z (mra_gan_tpu/ops/norm.py:_act_grad).
template <int ACT>
__device__ __forceinline__ float act_grad(float z, float slope) {
  if constexpr (ACT == ACT_RELU) return z >= 0.f ? 1.f : 0.f;
  if constexpr (ACT == ACT_LEAKY_RELU) return z >= 0.f ? 1.f : slope;
  if constexpr (ACT == ACT_TANH) {
    const float t = tanhf(z);
    return 1.f - t * t;
  }
  return 1.f;
}

// grid (S, N, ceil(G / blockDim.x)), block (gx, R) with G = C / VEC channel
// groups, gx = min(G, kThreads) and R = kThreads / gx voxel lanes.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
stats_kernel(const T* __restrict__ x, float* __restrict__ part_mean,
             float* __restrict__ part_m2, int64_t V, int C, int S) {
  extern __shared__ float smem[];
  const int G = C / VEC;
  const int gx = blockDim.x, R = blockDim.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int g = blockIdx.z * gx + tx;
  const int s = blockIdx.x;
  const int64_t n = blockIdx.y;
  const int64_t v0 = seg_begin(s, V, S), v1 = seg_begin(s + 1, V, S);

  float cnt = 0.f, mean[VEC], m2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) mean[i] = m2[i] = 0.f;
  if (g < G) {
    const T* p = x + n * V * C + (int64_t)g * VEC;
    int k = 0;
    for (int64_t v = v0 + ty; v < v1; v += R) {
      const Pack<T, VEC> pk = *reinterpret_cast<const Pack<T, VEC>*>(p + v * C);
      ++k;
      const float inv = 1.f / (float)k;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float xi = to_float(pk.v[i]);
        const float d = xi - mean[i];
        mean[i] += d * inv;
        m2[i] += d * (xi - mean[i]);
      }
    }
    cnt = (float)k;
  }

  // Tree over the R voxel lanes: at step `off`, lane ty (a multiple of
  // 2*off) folds in lane ty+off. Readers and writers of a step never share
  // a slot, and lane 0 ends with the whole segment.
  float* s_n = smem;
  float* s_mean = s_n + gx * R;
  float* s_m2 = s_mean + gx * R * VEC;
  const int slot = ty * gx + tx;
  s_n[slot] = cnt;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    s_mean[slot * VEC + i] = mean[i];
    s_m2[slot * VEC + i] = m2[i];
  }
  for (int off = 1; off < R; off <<= 1) {
    __syncthreads();
    if ((ty & (2 * off - 1)) == 0 && ty + off < R) {
      const int o = (ty + off) * gx + tx;
      const float nb = s_n[o];
      if (nb > 0.f) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          float na = cnt;
          chan_merge(na, mean[i], m2[i], nb, s_mean[o * VEC + i], s_m2[o * VEC + i]);
        }
        cnt += nb;
        s_n[slot] = cnt;
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          s_mean[slot * VEC + i] = mean[i];
          s_m2[slot * VEC + i] = m2[i];
        }
      }
    }
  }
  if (ty == 0 && g < G) {
    const int64_t o = (n * S + s) * C + (int64_t)g * VEC;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      part_mean[o + i] = mean[i];
      part_m2[o + i] = m2[i];
    }
  }
}

// grid (ceil(C / kFinX), N), block (kFinX, kFinY).
__global__ void __launch_bounds__(kFinX * kFinY)
finalize_kernel(const float* __restrict__ part_mean, const float* __restrict__ part_m2,
                float* __restrict__ mean, float* __restrict__ rstd,
                int64_t V, int C, int S, float eps) {
  __shared__ float s_n[kFinY][kFinX], s_m[kFinY][kFinX], s_q[kFinY][kFinX];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * kFinX + tx;
  const int64_t n = blockIdx.y;
  float cnt = 0.f, m = 0.f, q = 0.f;
  if (c < C) {
    for (int s = ty; s < S; s += kFinY) {
      const float nb = (float)(seg_begin(s + 1, V, S) - seg_begin(s, V, S));
      if (nb > 0.f) {
        const int64_t o = (n * S + s) * C + c;
        chan_merge(cnt, m, q, nb, part_mean[o], part_m2[o]);
      }
    }
  }
  s_n[ty][tx] = cnt;
  s_m[ty][tx] = m;
  s_q[ty][tx] = q;
  for (int off = 1; off < kFinY; off <<= 1) {
    __syncthreads();
    if ((ty & (2 * off - 1)) == 0) {
      const float nb = s_n[ty + off][tx];
      if (nb > 0.f) {
        chan_merge(cnt, m, q, nb, s_m[ty + off][tx], s_q[ty + off][tx]);
        s_n[ty][tx] = cnt;
        s_m[ty][tx] = m;
        s_q[ty][tx] = q;
      }
    }
  }
  if (ty == 0 && c < C) {
    mean[n * C + c] = m;
    rstd[n * C + c] = 1.f / sqrtf(q / (float)V + eps);
  }
}

// Same grid and block as stats_kernel.
template <typename T, int VEC, int ACT>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const T* __restrict__ x, const float* __restrict__ mean,
             const float* __restrict__ rstd, T* __restrict__ y,
             int64_t V, int C, int S, float slope) {
  const int G = C / VEC;
  const int g = blockIdx.z * blockDim.x + threadIdx.x;
  if (g >= G) return;
  const int s = blockIdx.x;
  const int64_t n = blockIdx.y;
  const int64_t v0 = seg_begin(s, V, S), v1 = seg_begin(s + 1, V, S);
  float mu[VEC], rs[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    mu[i] = mean[n * C + g * VEC + i];
    rs[i] = rstd[n * C + g * VEC + i];
  }
  const int64_t base = n * V * C + (int64_t)g * VEC;
  for (int64_t v = v0 + threadIdx.y; v < v1; v += blockDim.y) {
    const Pack<T, VEC> in = *reinterpret_cast<const Pack<T, VEC>*>(x + base + v * C);
    Pack<T, VEC> out;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float z = normalize(to_float(in.v[i]), mu[i], rs[i]);
      out.v[i] = from_float<T>(activate<ACT>(z, slope));
    }
    *reinterpret_cast<Pack<T, VEC>*>(y + base + v * C) = out;
  }
}

// Same grid and block as stats_kernel; shared memory 2 * VEC floats a thread.
template <typename T, int VEC, int ACT>
__global__ void __launch_bounds__(kThreads)
bwd_stats_kernel(const T* __restrict__ x, const T* __restrict__ g,
                 const float* __restrict__ mean, const float* __restrict__ rstd,
                 float* __restrict__ part_g, float* __restrict__ part_gz,
                 int64_t V, int C, int S, float slope) {
  extern __shared__ float smem[];
  const int G = C / VEC;
  const int gx = blockDim.x, R = blockDim.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int grp = blockIdx.z * gx + tx;
  const int s = blockIdx.x;
  const int64_t n = blockIdx.y;
  const int64_t v0 = seg_begin(s, V, S), v1 = seg_begin(s + 1, V, S);

  float sg[VEC], sgz[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) sg[i] = sgz[i] = 0.f;
  if (grp < G) {
    float mu[VEC], rs[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      mu[i] = mean[n * C + grp * VEC + i];
      rs[i] = rstd[n * C + grp * VEC + i];
    }
    const int64_t base = n * V * C + (int64_t)grp * VEC;
    for (int64_t v = v0 + ty; v < v1; v += R) {
      const Pack<T, VEC> xin = *reinterpret_cast<const Pack<T, VEC>*>(x + base + v * C);
      const Pack<T, VEC> gin = *reinterpret_cast<const Pack<T, VEC>*>(g + base + v * C);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float z = normalize(to_float(xin.v[i]), mu[i], rs[i]);
        const float gp = to_float(gin.v[i]) * act_grad<ACT>(z, slope);
        sg[i] += gp;
        sgz[i] += gp * z;
      }
    }
  }

  // The stats kernel's tree over the R voxel lanes, with plain sums.
  float* s_g = smem;
  float* s_gz = s_g + gx * R * VEC;
  const int slot = ty * gx + tx;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    s_g[slot * VEC + i] = sg[i];
    s_gz[slot * VEC + i] = sgz[i];
  }
  for (int off = 1; off < R; off <<= 1) {
    __syncthreads();
    if ((ty & (2 * off - 1)) == 0 && ty + off < R) {
      const int o = (ty + off) * gx + tx;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        sg[i] += s_g[o * VEC + i];
        sgz[i] += s_gz[o * VEC + i];
        s_g[slot * VEC + i] = sg[i];
        s_gz[slot * VEC + i] = sgz[i];
      }
    }
  }
  if (ty == 0 && grp < G) {
    const int64_t o = (n * S + s) * C + (int64_t)grp * VEC;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      part_g[o + i] = sg[i];
      part_gz[o + i] = sgz[i];
    }
  }
}

// grid (ceil(C / kFinX), N), block (kFinX, kFinY), as finalize_kernel.
__global__ void __launch_bounds__(kFinX * kFinY)
bwd_finalize_kernel(const float* __restrict__ part_g, const float* __restrict__ part_gz,
                    float* __restrict__ gmean, float* __restrict__ gzmean,
                    int64_t V, int C, int S) {
  __shared__ float s_g[kFinY][kFinX], s_z[kFinY][kFinX];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * kFinX + tx;
  const int64_t n = blockIdx.y;
  float a = 0.f, b = 0.f;
  if (c < C) {
    for (int s = ty; s < S; s += kFinY) {
      const int64_t o = (n * S + s) * C + c;
      a += part_g[o];
      b += part_gz[o];
    }
  }
  s_g[ty][tx] = a;
  s_z[ty][tx] = b;
  for (int off = 1; off < kFinY; off <<= 1) {
    __syncthreads();
    if ((ty & (2 * off - 1)) == 0) {
      a += s_g[ty + off][tx];
      b += s_z[ty + off][tx];
      s_g[ty][tx] = a;
      s_z[ty][tx] = b;
    }
  }
  if (ty == 0 && c < C) {
    gmean[n * C + c] = a / (float)V;
    gzmean[n * C + c] = b / (float)V;
  }
}

// Same grid and block as apply_kernel.
template <typename T, int VEC, int ACT>
__global__ void __launch_bounds__(kThreads)
bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ g,
                 const float* __restrict__ mean, const float* __restrict__ rstd,
                 const float* __restrict__ gmean, const float* __restrict__ gzmean,
                 T* __restrict__ dx, int64_t V, int C, int S, float slope) {
  const int G = C / VEC;
  const int grp = blockIdx.z * blockDim.x + threadIdx.x;
  if (grp >= G) return;
  const int s = blockIdx.x;
  const int64_t n = blockIdx.y;
  const int64_t v0 = seg_begin(s, V, S), v1 = seg_begin(s + 1, V, S);
  float mu[VEC], rs[VEC], gm[VEC], gzm[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int64_t o = n * C + grp * VEC + i;
    mu[i] = mean[o];
    rs[i] = rstd[o];
    gm[i] = gmean[o];
    gzm[i] = gzmean[o];
  }
  const int64_t base = n * V * C + (int64_t)grp * VEC;
  for (int64_t v = v0 + threadIdx.y; v < v1; v += blockDim.y) {
    const Pack<T, VEC> xin = *reinterpret_cast<const Pack<T, VEC>*>(x + base + v * C);
    const Pack<T, VEC> gin = *reinterpret_cast<const Pack<T, VEC>*>(g + base + v * C);
    Pack<T, VEC> out;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float z = normalize(to_float(xin.v[i]), mu[i], rs[i]);
      const float gp = to_float(gin.v[i]) * act_grad<ACT>(z, slope);
      out.v[i] = from_float<T>(rs[i] * (gp - gm[i] - z * gzm[i]));
    }
    *reinterpret_cast<Pack<T, VEC>*>(dx + base + v * C) = out;
  }
}

struct Geometry {
  dim3 grid, block;
  int threads;  // per block
};

template <int VEC>
Geometry geometry(int64_t N, int C, int S) {
  const int G = C / VEC;
  const int gx = G < kThreads ? G : kThreads;
  const int R = kThreads / gx;
  Geometry geo;
  geo.grid = dim3((unsigned)S, (unsigned)N, (unsigned)((G + gx - 1) / gx));
  geo.block = dim3((unsigned)gx, (unsigned)R);
  geo.threads = gx * R;
  return geo;
}

bool valid(int64_t N, int64_t V, int C, int S, int vec) {
  return N >= 1 && N <= 65535 && V >= 1 && C >= 1 && S >= 1 && vec >= 1 && C % vec == 0;
}

// Compile-time (element type, vector width, activation) for a launch.
template <typename T> struct Type { using type = T; };
template <int V> using Int = std::integral_constant<int, V>;

template <typename T, int VEC, typename F>
int with_act(int act, F&& f) {
  switch (act) {
    case ACT_NONE: return f(Type<T>{}, Int<VEC>{}, Int<ACT_NONE>{});
    case ACT_RELU: return f(Type<T>{}, Int<VEC>{}, Int<ACT_RELU>{});
    case ACT_LEAKY_RELU: return f(Type<T>{}, Int<VEC>{}, Int<ACT_LEAKY_RELU>{});
    case ACT_TANH: return f(Type<T>{}, Int<VEC>{}, Int<ACT_TANH>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// f(Type<T>, Int<VEC>, Int<ACT>) for the runtime codes; ACT_NONE where the
// kernel takes no activation.
template <typename F>
int dispatch(int dtype, int vec, int act, F&& f) {
  if (dtype == DT_F32 && vec == 4) return with_act<float, 4>(act, f);
  if (dtype == DT_F32 && vec == 1) return with_act<float, 1>(act, f);
  if (dtype == DT_BF16 && vec == 8) return with_act<__nv_bfloat16, 8>(act, f);
  if (dtype == DT_BF16 && vec == 1) return with_act<__nv_bfloat16, 1>(act, f);
  return (int)cudaErrorInvalidValue;
}

#define MRA_KERNEL_TYPES(t, v, a)              \
  using T = typename decltype(t)::type;        \
  constexpr int VEC = decltype(v)::value;      \
  constexpr int ACT = decltype(a)::value;      \
  (void)ACT

}  // namespace

extern "C" {

const char* mra_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// x (N, V, C) in `dtype`; part_mean, part_m2 (N, S, C) float32.
int mra_in_stats(const void* x, void* part_mean, void* part_m2, int64_t N, int64_t V,
                 int C, int S, int dtype, int vec, void* stream) {
  if (!valid(N, V, C, S, vec)) return (int)cudaErrorInvalidValue;
  return dispatch(dtype, vec, ACT_NONE, [&](auto t, auto v, auto a) {
    MRA_KERNEL_TYPES(t, v, a);
    const Geometry geo = geometry<VEC>(N, C, S);
    const size_t smem = (size_t)geo.threads * (1 + 2 * VEC) * sizeof(float);
    stats_kernel<T, VEC><<<geo.grid, geo.block, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<float*>(part_mean),
        static_cast<float*>(part_m2), V, C, S);
    return (int)cudaGetLastError();
  });
}

// part_mean, part_m2 (N, S, C) -> mean, rstd (N, C), all float32.
int mra_in_finalize(const void* part_mean, const void* part_m2, void* mean, void* rstd,
                    int64_t N, int64_t V, int C, int S, float eps, void* stream) {
  if (!valid(N, V, C, S, 1)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((C + kFinX - 1) / kFinX), (unsigned)N);
  const dim3 block(kFinX, kFinY);
  finalize_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part_mean), static_cast<const float*>(part_m2),
      static_cast<float*>(mean), static_cast<float*>(rstd), V, C, S, eps);
  return (int)cudaGetLastError();
}

// x, y (N, V, C) in `dtype`; mean, rstd (N, C) float32.
int mra_in_apply(const void* x, const void* mean, const void* rstd, void* y, int64_t N,
                 int64_t V, int C, int S, int dtype, int vec, int act, float slope,
                 void* stream) {
  if (!valid(N, V, C, S, vec)) return (int)cudaErrorInvalidValue;
  return dispatch(dtype, vec, act, [&](auto t, auto v, auto a) {
    MRA_KERNEL_TYPES(t, v, a);
    const Geometry geo = geometry<VEC>(N, C, S);
    apply_kernel<T, VEC, ACT><<<geo.grid, geo.block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const float*>(mean),
        static_cast<const float*>(rstd), static_cast<T*>(y), V, C, S, slope);
    return (int)cudaGetLastError();
  });
}

// x, g (N, V, C) in `dtype`; mean, rstd (N, C) and part_g, part_gz (N, S, C)
// float32.
int mra_in_bwd_stats(const void* x, const void* g, const void* mean, const void* rstd,
                     void* part_g, void* part_gz, int64_t N, int64_t V, int C, int S,
                     int dtype, int vec, int act, float slope, void* stream) {
  if (!valid(N, V, C, S, vec)) return (int)cudaErrorInvalidValue;
  return dispatch(dtype, vec, act, [&](auto t, auto v, auto a) {
    MRA_KERNEL_TYPES(t, v, a);
    const Geometry geo = geometry<VEC>(N, C, S);
    const size_t smem = (size_t)geo.threads * 2 * VEC * sizeof(float);
    bwd_stats_kernel<T, VEC, ACT>
        <<<geo.grid, geo.block, smem, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(x), static_cast<const T*>(g),
            static_cast<const float*>(mean), static_cast<const float*>(rstd),
            static_cast<float*>(part_g), static_cast<float*>(part_gz), V, C, S, slope);
    return (int)cudaGetLastError();
  });
}

// part_g, part_gz (N, S, C) -> gmean, gzmean (N, C), all float32.
int mra_in_bwd_finalize(const void* part_g, const void* part_gz, void* gmean, void* gzmean,
                        int64_t N, int64_t V, int C, int S, void* stream) {
  if (!valid(N, V, C, S, 1)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((C + kFinX - 1) / kFinX), (unsigned)N);
  const dim3 block(kFinX, kFinY);
  bwd_finalize_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part_g), static_cast<const float*>(part_gz),
      static_cast<float*>(gmean), static_cast<float*>(gzmean), V, C, S);
  return (int)cudaGetLastError();
}

// x, g, dx (N, V, C) in `dtype`; mean, rstd, gmean, gzmean (N, C) float32.
int mra_in_bwd_apply(const void* x, const void* g, const void* mean, const void* rstd,
                     const void* gmean, const void* gzmean, void* dx, int64_t N, int64_t V,
                     int C, int S, int dtype, int vec, int act, float slope, void* stream) {
  if (!valid(N, V, C, S, vec)) return (int)cudaErrorInvalidValue;
  return dispatch(dtype, vec, act, [&](auto t, auto v, auto a) {
    MRA_KERNEL_TYPES(t, v, a);
    const Geometry geo = geometry<VEC>(N, C, S);
    bwd_apply_kernel<T, VEC, ACT>
        <<<geo.grid, geo.block, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(x), static_cast<const T*>(g),
            static_cast<const float*>(mean), static_cast<const float*>(rstd),
            static_cast<const float*>(gmean), static_cast<const float*>(gzmean),
            static_cast<T*>(dx), V, C, S, slope);
    return (int)cudaGetLastError();
  });
}

}  // extern "C"
