// Fused affine-free InstanceNorm3d + activation, forward, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernels of mra_gan_tpu/ops/pallas/instance_norm.py:
//   _sum_kernel   (:86)  per-(n, c) statistics   -> stats_kernel + finalize_kernel
//   _apply_kernel (:100) normalise + activation  -> apply_kernel
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
// Plain C interface for ctypes; every launch goes on the caller's stream and
// returns cudaGetLastError() so that the wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

template <int ACT>
__device__ __forceinline__ float activate(float z, float slope) {
  if constexpr (ACT == ACT_RELU) return fmaxf(z, 0.f);
  if constexpr (ACT == ACT_LEAKY_RELU) return z >= 0.f ? z : slope * z;
  if constexpr (ACT == ACT_TANH) return tanhf(z);
  return z;
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
      const float z = (to_float(in.v[i]) - mu[i]) * rs[i];
      out.v[i] = from_float<T>(activate<ACT>(z, slope));
    }
    *reinterpret_cast<Pack<T, VEC>*>(y + base + v * C) = out;
  }
}

struct Geometry {
  dim3 grid, block;
  size_t smem;
};

template <int VEC>
Geometry geometry(int64_t N, int C, int S) {
  const int G = C / VEC;
  const int gx = G < kThreads ? G : kThreads;
  const int R = kThreads / gx;
  Geometry geo;
  geo.grid = dim3((unsigned)S, (unsigned)N, (unsigned)((G + gx - 1) / gx));
  geo.block = dim3((unsigned)gx, (unsigned)R);
  geo.smem = (size_t)gx * R * (1 + 2 * VEC) * sizeof(float);
  return geo;
}

bool valid(int64_t N, int64_t V, int C, int S, int vec) {
  return N >= 1 && N <= 65535 && V >= 1 && C >= 1 && S >= 1 && vec >= 1 && C % vec == 0;
}

template <typename T, int VEC>
int launch_stats(const void* x, void* pm, void* pq, int64_t N, int64_t V, int C, int S,
                 cudaStream_t stream) {
  const Geometry geo = geometry<VEC>(N, C, S);
  stats_kernel<T, VEC><<<geo.grid, geo.block, geo.smem, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(pm), static_cast<float*>(pq), V, C, S);
  return (int)cudaGetLastError();
}

template <typename T, int VEC, int ACT>
int launch_apply(const void* x, const void* mean, const void* rstd, void* y, int64_t N,
                 int64_t V, int C, int S, float slope, cudaStream_t stream) {
  const Geometry geo = geometry<VEC>(N, C, S);
  apply_kernel<T, VEC, ACT><<<geo.grid, geo.block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<T*>(y), V, C, S, slope);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int apply_act(int act, const void* x, const void* mean, const void* rstd, void* y,
              int64_t N, int64_t V, int C, int S, float slope, cudaStream_t stream) {
  switch (act) {
    case ACT_NONE: return launch_apply<T, VEC, ACT_NONE>(x, mean, rstd, y, N, V, C, S, slope, stream);
    case ACT_RELU: return launch_apply<T, VEC, ACT_RELU>(x, mean, rstd, y, N, V, C, S, slope, stream);
    case ACT_LEAKY_RELU:
      return launch_apply<T, VEC, ACT_LEAKY_RELU>(x, mean, rstd, y, N, V, C, S, slope, stream);
    case ACT_TANH: return launch_apply<T, VEC, ACT_TANH>(x, mean, rstd, y, N, V, C, S, slope, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* mra_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// x (N, V, C) in `dtype`; part_mean, part_m2 (N, S, C) float32.
int mra_in_stats(const void* x, void* part_mean, void* part_m2, int64_t N, int64_t V,
                 int C, int S, int dtype, int vec, void* stream) {
  if (!valid(N, V, C, S, vec)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32 && vec == 4) return launch_stats<float, 4>(x, part_mean, part_m2, N, V, C, S, st);
  if (dtype == DT_F32 && vec == 1) return launch_stats<float, 1>(x, part_mean, part_m2, N, V, C, S, st);
  if (dtype == DT_BF16 && vec == 8)
    return launch_stats<__nv_bfloat16, 8>(x, part_mean, part_m2, N, V, C, S, st);
  if (dtype == DT_BF16 && vec == 1)
    return launch_stats<__nv_bfloat16, 1>(x, part_mean, part_m2, N, V, C, S, st);
  return (int)cudaErrorInvalidValue;
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32 && vec == 4)
    return apply_act<float, 4>(act, x, mean, rstd, y, N, V, C, S, slope, st);
  if (dtype == DT_F32 && vec == 1)
    return apply_act<float, 1>(act, x, mean, rstd, y, N, V, C, S, slope, st);
  if (dtype == DT_BF16 && vec == 8)
    return apply_act<__nv_bfloat16, 8>(act, x, mean, rstd, y, N, V, C, S, slope, st);
  if (dtype == DT_BF16 && vec == 1)
    return apply_act<__nv_bfloat16, 1>(act, x, mean, rstd, y, N, V, C, S, slope, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
