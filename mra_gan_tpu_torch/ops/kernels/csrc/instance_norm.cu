// Fused affine-free InstanceNorm3d + activation, forward and backward, for
// Hopper (sm_90a).
//
// Replaces the TPU Pallas kernels of mra_gan_tpu/ops/pallas/instance_norm.py:
//   _sum_kernel       (:86)  per-(n, c) statistics  -> slab_kernel, or stats_kernel
//   _apply_kernel     (:100) normalise + activation -> slab_kernel, or apply_kernel
//   _bwd_sum_kernel   (:137) sums of g' and g'z     -> bwd_slab_kernel, or bwd_stats_kernel
//   _bwd_apply_kernel (:155) the input gradient     -> bwd_slab_kernel, or bwd_apply_kernel
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
// count: x read once and y written once at the least. The forward takes one
// of two routes, picked by the wrapper from the shape (uses_slab):
//
// One launch, where an instance fits in one SM's shared memory (the 16^3
// trunk and the PatchGAN's 16^3, 8^3 and 7^3 norms):
//   slab_kernel: one block per (n, 32-byte channel chunk) instance copies
//   its V x 32-byte slab of x into shared memory with cp.async (every 16-byte
//   copy of the thread in flight at once), takes the float32 mean and then
//   the centred sum of squares from shared memory (exact two-pass), writes
//   mean and rstd, and normalises from shared memory into y. x is read from
//   device memory once: the bound's traffic exactly.
//
// Two launches elsewhere (the 32^3 and 64^3 norms, the whole-volume pass,
// and C that is no multiple of a chunk):
//   1. stats_kernel reads x once. The TPU walks depth tiles in order and
//      carries the sum in one VMEM block; here blocks run in no order, so
//      the grid is (S segments, N samples, channel chunks) with S chosen by
//      the wrapper to fill the 132 SMs several times over. Each thread
//      issues kUnroll independent 16-byte loads per step and keeps one
//      Welford (count, mean, M2) stream per load slot in f32, all slots at
//      one count (one reciprocal per step, not per voxel); the slots and
//      then the block's threads are merged with Chan's formula, and the
//      block writes (N, S, C) f32 partials.
//   2. apply_kernel merges the S partials of its (n, channels) with Chan's
//      formula in its prologue (every block in the same order, so all agree
//      bit for bit, and the blocks of segment 0 write mean and rstd), then
//      reads x once more and writes y once; z is formed in f32 and rounded
//      once to x's dtype.
// Offsets are int64: a batch-8 full-volume tensor passes 2^31 elements.
//
// Backward (the analytic VJP, mra_gan_tpu/ops/norm.py:_in_vjp_bwd):
//   g' = g * act'(z),  dx = rstd * (g' - mean(g') - z * mean(g' z)),
// with z recomputed from x and the saved (mean, rstd): no activation is
// stored. The sums of g' and g'z are plain f32 sums (nothing cancels here
// the way E[x^2] - E[x]^2 does), and dx is formed in f32 and rounded once to
// g's dtype (the Pallas form, not the XLA one, which rounds at every step).
// Bound: memory again, x + g in and dx out at the least. The same two routes
// as the forward, on the same predicate (uses_slab), so a norm's forward
// and backward always take the same one:
//
// One launch where the forward's slab fits:
//   bwd_slab_kernel: one block per (n, 32-byte channel chunk) instance, on
//   slab_kernel's grid and block, copies x's slab into shared memory with
//   cp.async, and g's for as many voxels as the rest of the 224 KiB holds
//   (all of an 8^3 or 7^3 instance, 3/4 of a 16^3 one). Pass 1 sums g' and
//   g'z; pass 2 writes dx. x and g of a 16^3 instance would take 256 KiB,
//   more than a block may have, so the g that is not staged is streamed
//   twice (kUnroll loads in flight); the second read follows the first from
//   the same block, and the g in flight on the whole card (at most 32 KiB a
//   16^3 instance, one instance per SM) fits in the 50 MB L2, so device
//   memory sees x + g + dx: the bound's traffic. Staging what fits was
//   faster on the H100 than streaming all of g, at every slab shape of the
//   path; more loads in flight (8, 16) or 512 threads a block were not.
//
// Two launches elsewhere:
//   1. bwd_stats_kernel reads x and g once on the (S, N, chunk) grid, with
//      kUnroll independent 16-byte loads of each per step, and writes (N, S,
//      C) f32 partial sums of g' and g'z;
//   2. bwd_apply_kernel adds the S partials of its (n, channels) in its
//      prologue (every block in the same order, so all agree bit for bit),
//      divides by V, then reads x and g again and writes dx.
//
// z is formed by one function, normalize(), in every kernel, forward and
// backward, so a relu or leaky_relu mask at z ~ 0 is the same in all
// passes; act'(z) is taken at z >= 0, as in JAX.
//
// Plain C interface for ctypes; every launch goes on the caller's stream and
// returns cudaGetLastError() so that the wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;   // stats and apply blocks (the wrapper's _THREADS)
// independent 16-byte loads per thread and step, of x and of g in the
// backward (8 was slower for stats on the H100: more registers, fewer
// resident blocks)
constexpr int kUnroll = 4;
constexpr int kSlabThreads = 256;  // 128, 512 and 1024 were slower on the H100
// Dynamic shared memory for one slab (the wrapper's SLAB_BYTES): 224 KiB of
// the 227 KiB a block may have, the rest for the slab kernel's static sums.
constexpr int kSlabBytes = 224 * 1024;

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

// Welford: fold x into (mean, m2), inv being 1 / (the count with x).
__device__ __forceinline__ void welford(float& mean, float& m2, float x, float inv) {
  const float d = x - mean;
  mean += d * inv;
  m2 += d * (x - mean);
}

// One 16-byte asynchronous copy from device to shared memory (sm_80+).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// Wait for every cp.async of this thread; its copies are then visible to it.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Chan merge over the R = blockDim.y voxel lanes of a (gx, R) block, each
// thread holding (cnt, mean[VEC], m2[VEC]); smem holds gx * R * (1 + 2 VEC)
// floats. A tree: at step `off`, lane ty (a multiple of 2*off) folds in lane
// ty+off; readers and writers of a step never share a slot. Lane 0 ends with
// the whole in its registers and in slot tx of smem (s_n, then s_mean and
// s_m2 at VEC floats a slot), read after a __syncthreads().
template <int VEC>
__device__ __forceinline__ void merge_lanes(float& cnt, float* mean, float* m2, float* smem) {
  const int gx = blockDim.x, R = blockDim.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
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
}

// The one expression for z, forward and backward.
__device__ __forceinline__ float normalize(float x, float mu, float rs) {
  return (x - mu) * rs;
}

// rstd from the centred sum of squares over V voxels.
__device__ __forceinline__ float inv_std(float m2, int64_t V, float eps) {
  return 1.f / sqrtf(m2 / (float)V + eps);
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

// Fold one pack's g' = g act'(z) into s[0, VEC) and g'z into s[VEC, 2 VEC).
template <int ACT, typename T, int VEC>
__device__ __forceinline__ void add_grad_terms(float* s, const Pack<T, VEC>& xp,
                                               const Pack<T, VEC>& gp, const float* mu,
                                               const float* rs, float slope) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float z = normalize(to_float(xp.v[i]), mu[i], rs[i]);
    const float gq = to_float(gp.v[i]) * act_grad<ACT>(z, slope);
    s[i] += gq;
    s[VEC + i] += gq * z;
  }
}

// dx of one pack from the means gm of g' and gzm of g'z, in f32, rounded once.
template <int ACT, typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> input_grad(const Pack<T, VEC>& xp, const Pack<T, VEC>& gp,
                                                   const float* mu, const float* rs,
                                                   const float* gm, const float* gzm,
                                                   float slope) {
  Pack<T, VEC> out;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float z = normalize(to_float(xp.v[i]), mu[i], rs[i]);
    const float gq = to_float(gp.v[i]) * act_grad<ACT>(z, slope);
    out.v[i] = from_float<T>(rs[i] * (gq - gm[i] - z * gzm[i]));
  }
  return out;
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

  // Slot u takes voxels v0 + ty + u R, then every kUnroll R after; all
  // slots stand at count k in the main loop, so one reciprocal serves them.
  float cnt[kUnroll], mean[kUnroll][VEC], m2[kUnroll][VEC];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    cnt[u] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) mean[u][i] = m2[u][i] = 0.f;
  }
  if (g < G) {
    const T* p = x + n * V * C + (int64_t)g * VEC;
    int64_t v = v0 + ty;
    float k = 0.f;
    for (; v + (kUnroll - 1) * R < v1; v += kUnroll * R) {
      Pack<T, VEC> pk[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        pk[u] = *reinterpret_cast<const Pack<T, VEC>*>(p + (v + u * R) * C);
      k += 1.f;
      const float inv = 1.f / k;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int i = 0; i < VEC; ++i) welford(mean[u][i], m2[u][i], to_float(pk[u].v[i]), inv);
    }
    // fewer than kUnroll voxels are left: one to each of the first slots
    const float inv = 1.f / (k + 1.f);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      cnt[u] = k;
      if (v + u * R < v1) {
        const Pack<T, VEC> pk = *reinterpret_cast<const Pack<T, VEC>*>(p + (v + u * R) * C);
#pragma unroll
        for (int i = 0; i < VEC; ++i) welford(mean[u][i], m2[u][i], to_float(pk.v[i]), inv);
        cnt[u] = k + 1.f;
      }
    }
#pragma unroll
    for (int u = 1; u < kUnroll; ++u) {
      if (cnt[u] > 0.f) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          float na = cnt[0];
          chan_merge(na, mean[0][i], m2[0][i], cnt[u], mean[u][i], m2[u][i]);
        }
        cnt[0] += cnt[u];
      }
    }
  }

  merge_lanes<VEC>(cnt[0], mean[0], m2[0], smem);
  if (ty == 0 && g < G) {
    const int64_t o = (n * S + s) * C + (int64_t)g * VEC;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      part_mean[o + i] = mean[0][i];
      part_m2[o + i] = m2[0][i];
    }
  }
}

// Same grid and block as stats_kernel; shared memory as stats_kernel's.
// part_mean, part_m2 are the stats kernel's (N, S, C) partials on this grid.
template <typename T, int VEC, int ACT>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const T* __restrict__ x, const float* __restrict__ part_mean,
             const float* __restrict__ part_m2, float* __restrict__ mean,
             float* __restrict__ rstd, T* __restrict__ y, int64_t V, int C, int S,
             float eps, float slope) {
  extern __shared__ float smem[];
  const int G = C / VEC;
  const int gx = blockDim.x, R = blockDim.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int g = blockIdx.z * gx + tx;
  const int s = blockIdx.x;
  const int64_t n = blockIdx.y;

  // The merge: lane ty folds partials ty, ty + R, ... in order, then the
  // lanes' tree. Every block of (n, channels) does the same, in the same order.
  float cnt = 0.f, mu[VEC], rs[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) mu[i] = rs[i] = 0.f;
  if (g < G) {
    for (int j = ty; j < S; j += R) {
      const float nb = (float)(seg_begin(j + 1, V, S) - seg_begin(j, V, S));
      if (nb > 0.f) {
        const int64_t o = (n * S + j) * C + (int64_t)g * VEC;
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          float na = cnt;
          chan_merge(na, mu[i], rs[i], nb, part_mean[o + i], part_m2[o + i]);
        }
        cnt += nb;
      }
    }
  }
  merge_lanes<VEC>(cnt, mu, rs, smem);
  __syncthreads();
  const float* s_mean = smem + gx * R;
  const float* s_m2 = s_mean + gx * R * VEC;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    mu[i] = s_mean[tx * VEC + i];
    rs[i] = inv_std(s_m2[tx * VEC + i], V, eps);
  }
  if (g >= G) return;
  if (s == 0 && ty == 0) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      mean[n * C + g * VEC + i] = mu[i];
      rstd[n * C + g * VEC + i] = rs[i];
    }
  }

  const int64_t v0 = seg_begin(s, V, S), v1 = seg_begin(s + 1, V, S);
  const T* xp = x + n * V * C + (int64_t)g * VEC;
  T* yp = y + n * V * C + (int64_t)g * VEC;
  auto apply = [&](const Pack<T, VEC>& in) {
    Pack<T, VEC> out;
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      out.v[i] = from_float<T>(activate<ACT>(normalize(to_float(in.v[i]), mu[i], rs[i]), slope));
    return out;
  };
  int64_t v = v0 + ty;
  for (; v + (kUnroll - 1) * R < v1; v += kUnroll * R) {  // kUnroll loads in flight
    Pack<T, VEC> in[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      in[u] = *reinterpret_cast<const Pack<T, VEC>*>(xp + (v + u * R) * C);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      *reinterpret_cast<Pack<T, VEC>*>(yp + (v + u * R) * C) = apply(in[u]);
  }
  for (; v < v1; v += R)
    *reinterpret_cast<Pack<T, VEC>*>(yp + v * C) =
        apply(*reinterpret_cast<const Pack<T, VEC>*>(xp + v * C));
}

constexpr int kSlabWarps = kSlabThreads / 32;
// 16-byte packs per voxel in one slab instance: a 32-byte chunk of channels,
// one full sector (16 bf16 or 8 f32 channels).
constexpr int kSlabPacks = 2;
constexpr int kSlabChunk = kSlabPacks * 16;  // the wrapper's SLAB_CHUNK

// v[i] summed over the threads of a slab block with the same t % kSlabPacks:
// a shuffle tree inside each warp (xor by multiples of kSlabPacks keeps the
// pack), then the warps' sums from `red` (VEC * kSlabWarps * kSlabPacks
// floats) in warp order, so every thread of a pack ends with the same bits.
template <int VEC>
__device__ __forceinline__ void slab_sum(float* v, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, h = threadIdx.x % kSlabPacks;
#pragma unroll
  for (int i = 0; i < VEC; ++i)
#pragma unroll
    for (int o = kSlabPacks; o < 32; o <<= 1) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
  if (lane < kSlabPacks) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) red[(i * kSlabWarps + warp) * kSlabPacks + lane] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kSlabWarps; ++w) sum += red[(i * kSlabWarps + w) * kSlabPacks + h];
    v[i] = sum;
  }
  __syncthreads();  // red is free again
}

// grid (C / (kSlabPacks VEC) chunks, N), block kSlabThreads, dynamic shared
// memory V * kSlabChunk bytes. Thread t owns pack t % kSlabPacks of voxels
// t / kSlabPacks + k * lanes, and reads back from shared memory only what it
// copied there itself.
template <typename T, int VEC, int ACT>
__global__ void __launch_bounds__(kSlabThreads)
slab_kernel(const T* __restrict__ x, T* __restrict__ y, float* __restrict__ mean,
            float* __restrict__ rstd, int V, int C, float eps, float slope) {
  extern __shared__ __align__(16) unsigned char slab_raw[];
  __shared__ float red[VEC * kSlabWarps * kSlabPacks];
  using P = Pack<T, VEC>;
  P* slab = reinterpret_cast<P*>(slab_raw);
  constexpr int kLanes = kSlabThreads / kSlabPacks;
  const int h = threadIdx.x % kSlabPacks, lane = threadIdx.x / kSlabPacks;
  const int64_t n = blockIdx.y;
  const int c0 = (blockIdx.x * kSlabPacks + h) * VEC;
  const int64_t base = n * (int64_t)V * C + c0;

  for (int v = lane; v < V; v += kLanes)
    cp_async16(&slab[v * kSlabPacks + h], x + base + (int64_t)v * C);
  cp_async_wait_all();

  float mu[VEC], rs[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) mu[i] = 0.f;
  for (int v = lane; v < V; v += kLanes) {
    const P p = slab[v * kSlabPacks + h];
#pragma unroll
    for (int i = 0; i < VEC; ++i) mu[i] += to_float(p.v[i]);
  }
  slab_sum<VEC>(mu, red);
#pragma unroll
  for (int i = 0; i < VEC; ++i) mu[i] /= (float)V;

#pragma unroll
  for (int i = 0; i < VEC; ++i) rs[i] = 0.f;
  for (int v = lane; v < V; v += kLanes) {
    const P p = slab[v * kSlabPacks + h];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float d = to_float(p.v[i]) - mu[i];
      rs[i] = fmaf(d, d, rs[i]);
    }
  }
  slab_sum<VEC>(rs, red);
#pragma unroll
  for (int i = 0; i < VEC; ++i) rs[i] = inv_std(rs[i], V, eps);

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      mean[n * C + c0 + i] = mu[i];
      rstd[n * C + c0 + i] = rs[i];
    }
  }
  for (int v = lane; v < V; v += kLanes) {
    const P p = slab[v * kSlabPacks + h];
    P out;
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      out.v[i] = from_float<T>(activate<ACT>(normalize(to_float(p.v[i]), mu[i], rs[i]), slope));
    *reinterpret_cast<P*>(y + base + (int64_t)v * C) = out;
  }
}

// Plain sums over the R = blockDim.y voxel lanes of a (gx, R) block, each
// thread holding K floats; smem holds gx * R * K floats. merge_lanes's tree:
// lane 0 ends with the whole in its registers and in slot tx of smem, read
// after a __syncthreads().
template <int K>
__device__ __forceinline__ void sum_lanes(float* s, float* smem) {
  const int gx = blockDim.x, R = blockDim.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int slot = ty * gx + tx;
#pragma unroll
  for (int k = 0; k < K; ++k) smem[slot * K + k] = s[k];
  for (int off = 1; off < R; off <<= 1) {
    __syncthreads();
    if ((ty & (2 * off - 1)) == 0 && ty + off < R) {
      const int o = (ty + off) * gx + tx;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        s[k] += smem[o * K + k];
        smem[slot * K + k] = s[k];
      }
    }
  }
}

// grid (C / (kSlabPacks VEC) chunks, N), block kSlabThreads, dynamic shared
// memory (V + VG) * kSlabChunk bytes: x's slab as slab_kernel's, then g's
// slab for the last VG voxels. Thread t owns pack t % kSlabPacks of voxels
// t / kSlabPacks + k * lanes, and reads back from shared memory only what it
// copied there itself.
template <typename T, int VEC, int ACT>
__global__ void __launch_bounds__(kSlabThreads)
bwd_slab_kernel(const T* __restrict__ x, const T* __restrict__ g,
                const float* __restrict__ mean, const float* __restrict__ rstd,
                T* __restrict__ dx, int V, int VG, int C, float slope) {
  extern __shared__ __align__(16) unsigned char slab_raw[];
  __shared__ float red[2 * VEC * kSlabWarps * kSlabPacks];
  using P = Pack<T, VEC>;
  P* slab = reinterpret_cast<P*>(slab_raw);
  P* gslab = slab + V * kSlabPacks;  // g of voxel v >= v_staged at gslab[v - v_staged]
  constexpr int kLanes = kSlabThreads / kSlabPacks;
  const int h = threadIdx.x % kSlabPacks, lane = threadIdx.x / kSlabPacks;
  const int64_t n = blockIdx.y;
  const int c0 = (blockIdx.x * kSlabPacks + h) * VEC;
  const int64_t base = n * (int64_t)V * C + c0;
  const T* gp = g + base;
  const int v_staged = V - VG;

  for (int v = lane; v < V; v += kLanes) {
    cp_async16(&slab[v * kSlabPacks + h], x + base + (int64_t)v * C);
    if (v >= v_staged) cp_async16(&gslab[(v - v_staged) * kSlabPacks + h], gp + (int64_t)v * C);
  }
  float mu[VEC], rs[VEC], s[2 * VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    mu[i] = mean[n * C + c0 + i];
    rs[i] = rstd[n * C + c0 + i];
    s[i] = s[VEC + i] = 0.f;
  }
  cp_async_wait_all();
  auto gload = [&](int v) -> P {
    if (v >= v_staged) return gslab[(v - v_staged) * kSlabPacks + h];
    return *reinterpret_cast<const P*>(gp + (int64_t)v * C);
  };

  // pass 1: the sums of g' and g'z, kUnroll loads of g in flight
  int v = lane;
  for (; v + (kUnroll - 1) * kLanes < V; v += kUnroll * kLanes) {
    P gk[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) gk[u] = gload(v + u * kLanes);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      add_grad_terms<ACT>(s, slab[(v + u * kLanes) * kSlabPacks + h], gk[u], mu, rs, slope);
  }
  for (; v < V; v += kLanes)
    add_grad_terms<ACT>(s, slab[v * kSlabPacks + h], gload(v), mu, rs, slope);
  slab_sum<2 * VEC>(s, red);
#pragma unroll
  for (int i = 0; i < 2 * VEC; ++i) s[i] /= (float)V;

  // pass 2: g again (from L2 where not staged), x from shared memory, dx out
  T* dp = dx + base;
  v = lane;
  for (; v + (kUnroll - 1) * kLanes < V; v += kUnroll * kLanes) {
    P gk[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) gk[u] = gload(v + u * kLanes);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      *reinterpret_cast<P*>(dp + (int64_t)(v + u * kLanes) * C) = input_grad<ACT>(
          slab[(v + u * kLanes) * kSlabPacks + h], gk[u], mu, rs, s, s + VEC, slope);
  }
  for (; v < V; v += kLanes)
    *reinterpret_cast<P*>(dp + (int64_t)v * C) =
        input_grad<ACT>(slab[v * kSlabPacks + h], gload(v), mu, rs, s, s + VEC, slope);
}

// Same grid and block as stats_kernel; shared memory 2 * VEC floats a thread.
template <typename T, int VEC, int ACT>
__global__ void __launch_bounds__(kThreads)
bwd_stats_kernel(const T* __restrict__ x, const T* __restrict__ g,
                 const float* __restrict__ mean, const float* __restrict__ rstd,
                 float* __restrict__ part_g, float* __restrict__ part_gz,
                 int64_t V, int C, int S, float slope) {
  extern __shared__ float smem[];
  using P = Pack<T, VEC>;
  const int G = C / VEC;
  const int gx = blockDim.x, R = blockDim.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int grp = blockIdx.z * gx + tx;
  const int s = blockIdx.x;
  const int64_t n = blockIdx.y;
  const int64_t v0 = seg_begin(s, V, S), v1 = seg_begin(s + 1, V, S);

  float sum[2 * VEC];  // g' then g'z
#pragma unroll
  for (int i = 0; i < 2 * VEC; ++i) sum[i] = 0.f;
  if (grp < G) {
    float mu[VEC], rs[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      mu[i] = mean[n * C + grp * VEC + i];
      rs[i] = rstd[n * C + grp * VEC + i];
    }
    const T* xp = x + n * V * C + (int64_t)grp * VEC;
    const T* gp = g + n * V * C + (int64_t)grp * VEC;
    int64_t v = v0 + ty;
    for (; v + (kUnroll - 1) * R < v1; v += kUnroll * R) {  // kUnroll loads of each in flight
      P xk[kUnroll], gk[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        xk[u] = *reinterpret_cast<const P*>(xp + (v + u * R) * C);
        gk[u] = *reinterpret_cast<const P*>(gp + (v + u * R) * C);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) add_grad_terms<ACT>(sum, xk[u], gk[u], mu, rs, slope);
    }
    for (; v < v1; v += R)
      add_grad_terms<ACT>(sum, *reinterpret_cast<const P*>(xp + v * C),
                          *reinterpret_cast<const P*>(gp + v * C), mu, rs, slope);
  }

  sum_lanes<2 * VEC>(sum, smem);
  if (ty == 0 && grp < G) {
    const int64_t o = (n * S + s) * C + (int64_t)grp * VEC;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      part_g[o + i] = sum[i];
      part_gz[o + i] = sum[VEC + i];
    }
  }
}

// Same grid, block and shared memory as bwd_stats_kernel; part_g, part_gz
// are its (N, S, C) partials on this grid.
template <typename T, int VEC, int ACT>
__global__ void __launch_bounds__(kThreads)
bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ g,
                 const float* __restrict__ mean, const float* __restrict__ rstd,
                 const float* __restrict__ part_g, const float* __restrict__ part_gz,
                 T* __restrict__ dx, int64_t V, int C, int S, float slope) {
  extern __shared__ float smem[];
  using P = Pack<T, VEC>;
  const int G = C / VEC;
  const int gx = blockDim.x, R = blockDim.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int grp = blockIdx.z * gx + tx;
  const int s = blockIdx.x;
  const int64_t n = blockIdx.y;

  // The merge: lane ty adds partials ty, ty + R, ... in order, then the
  // lanes' tree. Every block of (n, channels) does the same, in the same order.
  float m[2 * VEC];  // mean(g') then mean(g'z)
#pragma unroll
  for (int i = 0; i < 2 * VEC; ++i) m[i] = 0.f;
  if (grp < G) {
    for (int j = ty; j < S; j += R) {
      const int64_t o = (n * S + j) * C + (int64_t)grp * VEC;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        m[i] += part_g[o + i];
        m[VEC + i] += part_gz[o + i];
      }
    }
  }
  sum_lanes<2 * VEC>(m, smem);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2 * VEC; ++i) m[i] = smem[tx * 2 * VEC + i] / (float)V;
  if (grp >= G) return;

  float mu[VEC], rs[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    mu[i] = mean[n * C + grp * VEC + i];
    rs[i] = rstd[n * C + grp * VEC + i];
  }
  const int64_t v0 = seg_begin(s, V, S), v1 = seg_begin(s + 1, V, S);
  const T* xp = x + n * V * C + (int64_t)grp * VEC;
  const T* gp = g + n * V * C + (int64_t)grp * VEC;
  T* dp = dx + n * V * C + (int64_t)grp * VEC;
  int64_t v = v0 + ty;
  for (; v + (kUnroll - 1) * R < v1; v += kUnroll * R) {  // kUnroll loads of each in flight
    P xk[kUnroll], gk[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      xk[u] = *reinterpret_cast<const P*>(xp + (v + u * R) * C);
      gk[u] = *reinterpret_cast<const P*>(gp + (v + u * R) * C);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      *reinterpret_cast<P*>(dp + (v + u * R) * C) =
          input_grad<ACT>(xk[u], gk[u], mu, rs, m, m + VEC, slope);
  }
  for (; v < v1; v += R)
    *reinterpret_cast<P*>(dp + v * C) =
        input_grad<ACT>(*reinterpret_cast<const P*>(xp + v * C),
                        *reinterpret_cast<const P*>(gp + v * C), mu, rs, m, m + VEC, slope);
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

// Prefer shared memory over L1 for `kernel` (its blocks' shared memory then
// never limits how many are resident) and allow it `dynamic` bytes of
// dynamic shared memory. Called from a static initialiser, once per kernel.
template <typename K>
cudaError_t prefer_shared(K kernel, int dynamic) {
  cudaError_t e = cudaSuccess;
  if (dynamic > 48 * 1024)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dynamic);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  return e;
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
    static const cudaError_t attr = prefer_shared(stats_kernel<T, VEC>, 0);
    if (attr != cudaSuccess) return (int)attr;
    stats_kernel<T, VEC><<<geo.grid, geo.block, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<float*>(part_mean),
        static_cast<float*>(part_m2), V, C, S);
    return (int)cudaGetLastError();
  });
}

// x, y (N, V, C) in `dtype`; part_mean, part_m2 (N, S, C) from mra_in_stats
// with the same S; mean, rstd (N, C), written here. All stats float32.
int mra_in_apply(const void* x, const void* part_mean, const void* part_m2, void* mean,
                 void* rstd, void* y, int64_t N, int64_t V, int C, int S, int dtype, int vec,
                 int act, float eps, float slope, void* stream) {
  if (!valid(N, V, C, S, vec)) return (int)cudaErrorInvalidValue;
  return dispatch(dtype, vec, act, [&](auto t, auto v, auto a) {
    MRA_KERNEL_TYPES(t, v, a);
    const Geometry geo = geometry<VEC>(N, C, S);
    const size_t smem = (size_t)geo.threads * (1 + 2 * VEC) * sizeof(float);
    static const cudaError_t attr = prefer_shared(apply_kernel<T, VEC, ACT>, 0);
    if (attr != cudaSuccess) return (int)attr;
    apply_kernel<T, VEC, ACT><<<geo.grid, geo.block, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const float*>(part_mean),
        static_cast<const float*>(part_m2), static_cast<float*>(mean),
        static_cast<float*>(rstd), static_cast<T*>(y), V, C, S, eps, slope);
    return (int)cudaGetLastError();
  });
}

// x, y (N, V, C) in `dtype`, 16-byte aligned; mean, rstd (N, C) float32.
// One block per (n, 32-byte channel chunk); V * kSlabChunk must fit in
// kSlabBytes.
int mra_in_slab(const void* x, void* y, void* mean, void* rstd, int64_t N, int64_t V, int C,
                int dtype, int act, float eps, float slope, void* stream) {
  const int es = dtype == DT_BF16 ? 2 : 4;
  if (!valid(N, V, C, 1, 1) || (C * es) % kSlabChunk != 0 || V * kSlabChunk > kSlabBytes)
    return (int)cudaErrorInvalidValue;
  auto f = [&](auto t, auto v, auto a) {
    MRA_KERNEL_TYPES(t, v, a);
    static const cudaError_t attr = prefer_shared(slab_kernel<T, VEC, ACT>, kSlabBytes);
    if (attr != cudaSuccess) return (int)attr;
    const dim3 grid((unsigned)(C / (kSlabPacks * VEC)), (unsigned)N);
    slab_kernel<T, VEC, ACT>
        <<<grid, kSlabThreads, (size_t)V * kSlabChunk, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(x), static_cast<T*>(y), static_cast<float*>(mean),
            static_cast<float*>(rstd), (int)V, C, eps, slope);
    return (int)cudaGetLastError();
  };
  // 16-byte packs only
  if (dtype == DT_BF16) return with_act<__nv_bfloat16, 8>(act, f);
  if (dtype == DT_F32) return with_act<float, 4>(act, f);
  return (int)cudaErrorInvalidValue;
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

// x, g, dx (N, V, C) in `dtype`; mean, rstd (N, C) float32; part_g,
// part_gz (N, S, C) float32 from mra_in_bwd_stats with the same S.
int mra_in_bwd_apply(const void* x, const void* g, const void* mean, const void* rstd,
                     const void* part_g, const void* part_gz, void* dx, int64_t N, int64_t V,
                     int C, int S, int dtype, int vec, int act, float slope, void* stream) {
  if (!valid(N, V, C, S, vec)) return (int)cudaErrorInvalidValue;
  return dispatch(dtype, vec, act, [&](auto t, auto v, auto a) {
    MRA_KERNEL_TYPES(t, v, a);
    const Geometry geo = geometry<VEC>(N, C, S);
    const size_t smem = (size_t)geo.threads * 2 * VEC * sizeof(float);
    bwd_apply_kernel<T, VEC, ACT>
        <<<geo.grid, geo.block, smem, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(x), static_cast<const T*>(g),
            static_cast<const float*>(mean), static_cast<const float*>(rstd),
            static_cast<const float*>(part_g), static_cast<const float*>(part_gz),
            static_cast<T*>(dx), V, C, S, slope);
    return (int)cudaGetLastError();
  });
}

// x, g, dx (N, V, C) in `dtype`, 16-byte aligned; mean, rstd (N, C)
// float32. mra_in_slab's grid and limits; g is staged for as many voxels
// as the shared memory that x's slab leaves free holds.
int mra_in_bwd_slab(const void* x, const void* g, const void* mean, const void* rstd, void* dx,
                    int64_t N, int64_t V, int C, int dtype, int act, float slope, void* stream) {
  const int es = dtype == DT_BF16 ? 2 : 4;
  if (!valid(N, V, C, 1, 1) || (C * es) % kSlabChunk != 0 || V * kSlabChunk > kSlabBytes)
    return (int)cudaErrorInvalidValue;
  const int64_t vg = V < kSlabBytes / kSlabChunk - V ? V : kSlabBytes / kSlabChunk - V;
  auto f = [&](auto t, auto v, auto a) {
    MRA_KERNEL_TYPES(t, v, a);
    static const cudaError_t attr = prefer_shared(bwd_slab_kernel<T, VEC, ACT>, kSlabBytes);
    if (attr != cudaSuccess) return (int)attr;
    const dim3 grid((unsigned)(C / (kSlabPacks * VEC)), (unsigned)N);
    bwd_slab_kernel<T, VEC, ACT><<<grid, kSlabThreads, (size_t)(V + vg) * kSlabChunk,
                                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const float*>(mean),
        static_cast<const float*>(rstd), static_cast<T*>(dx), (int)V, (int)vg, C, slope);
    return (int)cudaGetLastError();
  };
  if (dtype == DT_BF16) return with_act<__nv_bfloat16, 8>(act, f);
  if (dtype == DT_F32) return with_act<float, 4>(act, f);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
