// Replication (edge) padding of a 3D volume, forward and backward, for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: the JAX package pads with XLA's edge pad
// (jnp.pad(mode="edge"), mra_gan_tpu/ops/conv.py:131-150), whose VJP XLA
// sums in a fixed order. On the card the port padded with PyTorch's
// F.pad(mode="replicate"), whose CUDA backward adds into the input gradient
// with atomics: a bfloat16 rounding at every add, in an order that changes
// from run to run. These two kernels take its place on the resnet
// generator's 14 pads a forward (the stem's and the head's 3-voxel pads, the
// residual blocks' 1-voxel pads), on every path.
//
// Layout: x is NDHWC in memory (a torch NCDHW tensor in channels_last_3d), so
// the C channels of a voxel are contiguous. Pads are per axis, low and high:
// (pd0, pd1, ph0, ph1, pw0, pw1); the output box is (D + pd0 + pd1, ...).
//
// Forward, replication_pad_fwd_kernel: y[o] = x[clamp(o - p_lo, 0, n - 1)]
// on each axis. One block per output row (n, od, oh); its threads walk the
// row's Wo x C channels in units of U: 16 bytes (uint4) where C * sizeof(T)
// is a multiple of 16 and both tensors are 16-byte aligned, else one element.
// Neighbouring threads move neighbouring units, so both the row's load and
// its store are coalesced. A pure copy: any dtype of U's width.
//
// Backward, replication_pad_bwd_kernel: a gather, no atomics. Each input
// voxel i sums the output gradients of every output whose clamped index is
// i; along an axis of n voxels that range is
//   [i == 0 ? 0 : i + p_lo, i == n - 1 ? n - 1 + p_lo + p_hi : i + p_lo],
// one output inside the box, the pad's outputs too at either end (both at an
// axis of one voxel). The sum is folded W first, then H, then D, each fold
// left to right and starting from its first term, in float32 (float64 for a
// float64 gradient), and rounded once to T. That is the plain version's
// association (replication_pad_bwd_plain: three folds of the whole tensor in
// float32), so kernel and plain version agree bit for bit, and nothing
// depends on the order in which threads run. One block per input row
// (n, d, h); its threads walk the row's W x C channels, VEC channels a
// thread (one 16-byte load a term, VEC float accumulators) where
// C * sizeof(T) is a multiple of 16, else one.
//
// Bound: memory. Each input element is read once and each output element
// written once (the backward reads every output gradient exactly once: the
// ranges of neighbouring input voxels do not overlap), so the least traffic
// is |x| + |y| bytes each way. Offsets are int64: a single-pass volume
// passes 2^31 bytes. A simple, coalesced kernel: no shared memory, no TMA;
// a thread's edge terms are strided loads of neighbouring outputs.
//
// C interface (ctypes, ops/kernels/replication_pad.py): mra_pad_fwd and
// mra_pad_bwd take the launch's parameters as one int array (worked out once
// a shape on the host), launch on the caller's stream and return a
// cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

enum DType : int { DT_F32 = 0, DT_BF16 = 1, DT_F64 = 2 };

constexpr int kVecBytes = 16;
constexpr int kMaxThreads = 1024;

struct Box {
  int N, C, D, H, W;       // the input
  int Do, Ho, Wo;          // the output
  int pd, ph, pw;          // the low pads
};

__device__ __forceinline__ int clampi(int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); }

// The outputs whose clamped index along an axis of n voxels (low pad p, the
// padded axis no outputs long) is i: [lo, hi].
__device__ __forceinline__ int range_lo(int i, int p) { return i == 0 ? 0 : i + p; }
__device__ __forceinline__ int range_hi(int i, int n, int p, int no) {
  return i == n - 1 ? no - 1 : i + p;
}

// U: the unit a thread moves, 16 bytes or one element.
template <typename U>
__global__ void __launch_bounds__(kMaxThreads)
replication_pad_fwd_kernel(const U* __restrict__ x, U* __restrict__ y, Box b, int units) {
  const int row = blockIdx.x;  // (n, od, oh)
  const int oh = row % b.Ho;
  const int od = (row / b.Ho) % b.Do;
  const int n = row / (b.Ho * b.Do);
  const int id = clampi(od - b.pd, b.D - 1), ih = clampi(oh - b.ph, b.H - 1);
  const U* src = x + (((int64_t)n * b.D + id) * b.H + ih) * b.W * units;
  U* dst = y + (int64_t)row * b.Wo * units;
  const int len = b.Wo * units;
  for (int j = threadIdx.x; j < len; j += blockDim.x) {
    const int ow = j / units, u = j - ow * units;
    dst[j] = src[clampi(ow - b.pw, b.W - 1) * units + u];
  }
}

template <typename T> struct Acc { using type = float; };
template <> struct Acc<double> { using type = double; };

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ double widen(double v) { return v; }

template <typename T> __device__ __forceinline__ T narrow(typename Acc<T>::type v);
template <> __device__ __forceinline__ float narrow<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ double narrow<double>(double v) { return v; }

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
replication_pad_bwd_kernel(const T* __restrict__ g, T* __restrict__ dx, Box b) {
  using A = typename Acc<T>::type;
  using P = Pack<T, VEC>;
  const int units = b.C / VEC;
  const int row = blockIdx.x;  // (n, d, h)
  const int h = row % b.H;
  const int d = (row / b.H) % b.D;
  const int n = row / (b.H * b.D);
  const int od0 = range_lo(d, b.pd), od1 = range_hi(d, b.D, b.pd, b.Do);
  const int oh0 = range_lo(h, b.ph), oh1 = range_hi(h, b.H, b.ph, b.Ho);
  const P* gp = reinterpret_cast<const P*>(g);
  P* out = reinterpret_cast<P*>(dx) + (int64_t)row * b.W * units;
  const int len = b.W * units;
  for (int j = threadIdx.x; j < len; j += blockDim.x) {
    const int w = j / units, u = j - w * units;
    const int ow0 = range_lo(w, b.pw), ow1 = range_hi(w, b.W, b.pw, b.Wo);
    A acc_d[VEC], acc_h[VEC], acc_w[VEC];
    for (int od = od0; od <= od1; ++od) {
      for (int oh = oh0; oh <= oh1; ++oh) {
        const P* src = gp + (((int64_t)n * b.Do + od) * b.Ho + oh) * b.Wo * units + u;
        P t = src[(int64_t)ow0 * units];
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc_w[k] = widen(t.v[k]);
        for (int ow = ow0 + 1; ow <= ow1; ++ow) {
          t = src[(int64_t)ow * units];
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc_w[k] += widen(t.v[k]);
        }
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc_h[k] = oh == oh0 ? acc_w[k] : acc_h[k] + acc_w[k];
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc_d[k] = od == od0 ? acc_h[k] : acc_d[k] + acc_h[k];
    }
    P r;
#pragma unroll
    for (int k = 0; k < VEC; ++k) r.v[k] = narrow<T>(acc_d[k]);
    out[j] = r;
  }
}

int elem_bytes(int dtype) {
  switch (dtype) {
    case DT_F32: return 4;
    case DT_BF16: return 2;
    case DT_F64: return 8;
    default: return 0;
  }
}

// The box and its checks: every size positive, the pads not negative, the
// output box the input grown by the pads, vec 1 or 16 bytes of elements
// dividing C, threads a multiple of 32 up to kMaxThreads.
bool make_box(Box* b, int N, int C, int D, int H, int W, int pd0, int pd1, int ph0, int ph1,
              int pw0, int pw1, int es, int vec, int threads) {
  if (es == 0 || N < 1 || C < 1 || D < 1 || H < 1 || W < 1) return false;
  if (pd0 < 0 || pd1 < 0 || ph0 < 0 || ph1 < 0 || pw0 < 0 || pw1 < 0) return false;
  if (!(vec == 1 || (vec * es == kVecBytes && C % vec == 0))) return false;
  if (threads < 32 || threads > kMaxThreads || threads % 32) return false;
  *b = Box{N, C, D, H, W, D + pd0 + pd1, H + ph0 + ph1, W + pw0 + pw1, pd0, ph0, pw0};
  return true;
}

template <typename U>
cudaError_t launch_fwd(const void* x, void* y, const Box& b, int units, int threads,
                       cudaStream_t s) {
  const int64_t rows = (int64_t)b.N * b.Do * b.Ho;
  replication_pad_fwd_kernel<U><<<(unsigned)rows, threads, 0, s>>>(
      static_cast<const U*>(x), static_cast<U*>(y), b, units);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_bwd(const void* g, void* dx, const Box& b, int threads, cudaStream_t s) {
  const int64_t rows = (int64_t)b.N * b.D * b.H;
  replication_pad_bwd_kernel<T, VEC><<<(unsigned)rows, threads, 0, s>>>(
      static_cast<const T*>(g), static_cast<T*>(dx), b);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* mra_pad_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// p: the launch's parameters (ops/kernels/replication_pad.py launch_plan),
// {dtype, N, C, D, H, W, pd0, pd1, ph0, ph1, pw0, pw1, vec, threads}: the
// input box (N, D, H, W, C) in `dtype`, the pads, the elements a thread
// moves (1, or 16 bytes' worth) and the block. mra_pad_fwd: x (N, D, H, W, C)
// -> y (N, D + pd0 + pd1, H + ph0 + ph1, W + pw0 + pw1, C).
int mra_pad_fwd(const void* x, void* y, const int* p, void* stream) {
  const int dtype = p[0], es = elem_bytes(dtype), C = p[2], vec = p[12], threads = p[13];
  Box b;
  if (!make_box(&b, p[1], C, p[3], p[4], p[5], p[6], p[7], p[8], p[9], p[10], p[11], es, vec,
                threads))
    return (int)cudaErrorInvalidValue;
  if ((int64_t)b.N * b.Do * b.Ho > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec > 1) return (int)launch_fwd<uint4>(x, y, b, C / vec, threads, s);
  switch (es) {
    case 2: return (int)launch_fwd<uint16_t>(x, y, b, C, threads, s);
    case 4: return (int)launch_fwd<uint32_t>(x, y, b, C, threads, s);
    default: return (int)launch_fwd<uint64_t>(x, y, b, C, threads, s);
  }
}

// g (N, Do, Ho, Wo, C), the output gradient of mra_pad_fwd with the same
// parameters -> dx (N, D, H, W, C).
int mra_pad_bwd(const void* g, void* dx, const int* p, void* stream) {
  const int dtype = p[0], vec = p[12], threads = p[13];
  Box b;
  if (!make_box(&b, p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9], p[10], p[11],
                elem_bytes(dtype), vec, threads))
    return (int)cudaErrorInvalidValue;
  if ((int64_t)b.N * b.D * b.H > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32:
      return (int)(vec > 1 ? launch_bwd<float, 4>(g, dx, b, threads, s)
                           : launch_bwd<float, 1>(g, dx, b, threads, s));
    case DT_BF16:
      return (int)(vec > 1 ? launch_bwd<__nv_bfloat16, 8>(g, dx, b, threads, s)
                           : launch_bwd<__nv_bfloat16, 1>(g, dx, b, threads, s));
    default:
      return (int)(vec > 1 ? launch_bwd<double, 2>(g, dx, b, threads, s)
                           : launch_bwd<double, 1>(g, dx, b, threads, s));
  }
}

}  // extern "C"
