// Replication (edge) padding of a 3D volume, forward and backward, for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: the JAX package pads with XLA's edge pad
// (jnp.pad(mode="edge"), mra_gan_tpu/ops/conv.py:131-150), whose VJP XLA
// sums in a fixed order. On the card the port padded with PyTorch's
// F.pad(mode="replicate"), whose CUDA backward adds into the input gradient
// with atomics: a bfloat16 rounding at every add, in an order that changes
// from run to run. These kernels take its place on the resnet generator's 14
// pads a forward (the stem's and the head's 3-voxel pads, the residual
// blocks' 1-voxel pads), on every path.
//
// Layout: x is NDHWC in memory (a torch NCDHW tensor in channels_last_3d), so
// the C channels of a voxel are contiguous and so is every row (n, d, h) of
// W x C elements. Pads are per axis, low and high: (pd0, pd1, ph0, ph1, pw0,
// pw1); the output box is (D + pd0 + pd1, ...).
//
// Forward: y[o] = x[clamp(o - p_lo, 0, n - 1)] on each axis. Backward, a
// gather with no atomics: each input voxel i sums the output gradients of
// every output whose clamped index is i; along an axis of n voxels that range
// is
//   [i == 0 ? 0 : i + p_lo, i == n - 1 ? n - 1 + p_lo + p_hi : i + p_lo],
// one output inside the box, the pad's outputs too at either end (both at an
// axis of one voxel). The sum is folded W first, then H, then D, each fold
// left to right and starting from its first term, in float32 (float64 for a
// float64 gradient), and rounded once to T: the plain version's association
// (replication_pad_bwd_plain), so kernel and plain version agree bit for bit
// and nothing depends on the order in which blocks run.
//
// What bounds both: the memory rate. Each reads its source once and writes
// its destination once, |x| + |y| bytes, and computes next to nothing. The
// host (ops/kernels/replication_pad.py launch_plan, once a shape) picks one
// of four kernels from the shape, never from a flag:
//
// - replication_pad_fwd_kernel, where a voxel's channels fill whole 16-byte
//   units and both tensors are 16-byte aligned (the head, C = 32, and the
//   trunk, C = 128, in bf16): one block an output row (n, od, oh), each
//   thread a 16-byte unit, loads and stores coalesced. Measured on an H100 it
//   reaches 80-86% of its byte bound at the head; a staged, persistent
//   version of it was no faster there and slower at the trunk.
// - replication_pad_fwd_chunks_kernel, everywhere else (C = 1 at the stem,
//   C = 6, a source that is not 16-byte aligned): a voxel an element wide
//   moved an element a thread keeps 8 of 16 bytes a store idle and runs
//   tens of thousands of tiny blocks. Here each thread writes one 16-byte
//   chunk of an output plane (n, od), the plane cut on absolute 16-byte
//   boundaries (the chunks at its ends, shared with the neighbouring planes,
//   write only their own elements), and reads each element by its clamped
//   index (H x W x C by per-shape constants, a multiply and a shift); the
//   plane's input rows stay in L1 and L2 for its blocks.
// - replication_pad_bwd_ring_kernel, the unit path's backward (the head and
//   the trunk). A simple gather (a block an input row) keeps one 16-byte
//   load in flight a thread, and its blocks on a D or H face fold 4 rows of
//   the gradient serially (a corner row 16, at pad 3): a tail of heavy
//   blocks. Here a tile (the plan's unit of work: (n, d, rows h0..h1,
//   columns w0..w1), whole rows or a piece of one row) has the gradient
//   rows that fold into it staged in shared memory by the bulk-copy engine
//   (cp.async.bulk, completion counted in bytes on an mbarrier), at every
//   depth of its fold, into a ring of up to kMaxStages stages: the next
//   tiles' copies are in flight while this one is summed, and no register
//   waits on a load. The rows whose D and H folds are one term (a middle
//   plane's middle rows: widening and rounding back gives the same bits)
//   are stored from the stage by the bulk-copy engine too; the threads sum
//   the edge voxels and the rows of several terms, a 16-byte unit a thread.
//   The plan sizes tiles by bytes, not rows: the first, middle and last
//   planes and rows of the box each get rows per tile or pieces per row so
//   that a tile moves about the same bytes, so a corner row is cut into
//   pieces instead of one block carrying it whole. The grid is persistent,
//   two blocks a multiprocessor, and block b walks tiles b, b + G, b + 2G,
//   ...: the whole grid works on neighbouring tiles at any time, and the
//   tiles, sized by bytes, balance the blocks. Thread 0 decodes each tile
//   once, as it issues its copies, into a slot beside the stage.
// - replication_pad_bwd_kernel, every other backward: a voxel narrower than
//   a unit or an unaligned gradient (the stem), and a voxel so wide that a
//   corner's fold does not fit half the ring (float64 at C = 128, pad 3).
//   One block an input row, VEC channels a thread (one 16-byte load a term)
//   where a voxel is whole units, else one. Staged 16-byte chunks were 1.4x
//   slower at the stem on an H100: its rows are 140 bytes, so the threads'
//   work per chunk, not the memory, set their pace.
//
// Offsets into the tensors are int64: a single-pass volume passes 2^31
// bytes. A stage whose copies never land ends the kernel with a trap after
// seconds rather than leave the card spinning.
//
// C interface (ctypes, ops/kernels/replication_pad.py): mra_pad_fwd and
// mra_pad_bwd take the launch's parameters as one int array (launch_plan,
// worked out once a shape on the host; after a short header it is the Plan
// itself, which the ring kernel takes by value), launch on the caller's
// stream and return a cudaError_t; mra_pad_sms gives a device's
// multiprocessors.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

enum DType : int { DT_F32 = 0, DT_BF16 = 1, DT_F64 = 2 };
// the kernel a launch runs: a block a row, 16-byte chunks of a plane, the ring
enum Route : int { ROUTE_ROWS = 0, ROUTE_CHUNKS = 1, ROUTE_RING = 2 };

constexpr int kVecBytes = 16;        // a unit, a chunk
constexpr int kMaxThreads = 1024;    // a row kernel's block, at most
constexpr int kChunkThreads = 128;   // the chunk kernel's block
constexpr int kRingThreads = 256;    // the ring kernel's block
constexpr int kMaxStages = 8;        // the ring's largest depth
constexpr int kSmemLimit = 227 * 1024;

// n / d as (umulhi(n, m) + n) >> s, exact for 0 <= n < 2^31
struct FastDiv {
  int d;
  uint32_t m, s;
};

// the box and the launch, the scalars a kernel keeps in registers
struct Geo {
  int N, C, D, H, W, Do, Ho, Wo;
  int pd, ph, pw;  // the low pads
  int plane_blocks;  // the chunk kernel's blocks an output plane
  int stage_bytes, stages, tiles, sample_tiles;  // the ring's
  FastDiv row, vox;  // the destination's row and voxel, in elements (units for the ring)
};

// the ring's tile tables, which its kernel copies into shared memory: tiles
// of a plane of the first, middle and last depth class; per (depth class,
// row class): rows a tile, pieces a row, piece width, row tiles
constexpr int kPlaneTiles = 0, kRows = 3, kPieces = 12, kWidth = 21, kRowTiles = 30,
              kTable = 39;

struct Plan {
  Geo geo;
  int table[kTable];
};

struct Tile {
  int n, d, h0, h1, w0, w1;  // inclusive
};

__device__ __forceinline__ int clampi(int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); }
__device__ __forceinline__ int fold_lo(int i, int p) { return i == 0 ? 0 : i + p; }
__device__ __forceinline__ int fold_hi(int i, int n, int p, int no) {
  return i == n - 1 ? no - 1 : i + p;
}
__device__ __forceinline__ int fdiv(const FastDiv& f, int n) {
  return (int)((__umulhi((uint32_t)n, f.m) + (uint32_t)n) >> f.s);
}

// ---------------------------------------------------------------------------
// elements

template <int ES> struct Bits;
template <> struct Bits<2> { using U = uint16_t; };
template <> struct Bits<4> { using U = uint32_t; };
template <> struct Bits<8> { using U = unsigned long long; };

// a 16-byte chunk as one unit or as its elements' bits
template <int ES>
union Chunk {
  uint4 v;
  typename Bits<ES>::U e[kVecBytes / ES];
};

// the backward's element types: the accumulator, widening from and
// rounding to the bits
template <typename T> struct Elem;
template <> struct Elem<float> {
  using A = float;
  static __device__ __forceinline__ A widen(uint32_t b) { return __uint_as_float(b); }
  static __device__ __forceinline__ uint32_t narrow(A v) { return __float_as_uint(v); }
};
template <> struct Elem<__nv_bfloat16> {
  using A = float;
  static __device__ __forceinline__ A widen(uint16_t b) { return __uint_as_float((uint32_t)b << 16); }
  static __device__ __forceinline__ uint16_t narrow(A v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};
template <> struct Elem<double> {
  using A = double;
  static __device__ __forceinline__ A widen(unsigned long long b) {
    return __longlong_as_double((long long)b);
  }
  static __device__ __forceinline__ unsigned long long narrow(A v) {
    return (unsigned long long)__double_as_longlong(v);
  }
};

// ---------------------------------------------------------------------------
// forward

// A voxel of `units` 16-byte units: one block an output row (n, od, oh), its
// threads the row's units.
__global__ void __launch_bounds__(kMaxThreads)
replication_pad_fwd_kernel(const uint4* __restrict__ x, uint4* __restrict__ y, const Geo b,
                           int units) {
  const int row = blockIdx.x;  // (n, od, oh)
  const int oh = row % b.Ho;
  const int od = (row / b.Ho) % b.Do;
  const int n = row / (b.Ho * b.Do);
  const int id = clampi(od - b.pd, b.D - 1), ih = clampi(oh - b.ph, b.H - 1);
  const uint4* src = x + (((int64_t)n * b.D + id) * b.H + ih) * b.W * units;
  uint4* dst = y + (int64_t)row * b.Wo * units;
  const int len = b.Wo * units;
  for (int j = threadIdx.x; j < len; j += blockDim.x) {
    const int ow = j / units, u = j - ow * units;
    dst[j] = src[clampi(ow - b.pw, b.W - 1) * units + u];
  }
}

// Any other voxel: thread j of an output plane's plane_blocks x kChunkThreads
// writes the plane's 16-byte aligned chunk j. The plane (n, od) holds len =
// Ho x Wo x C elements from element `first` of y on, `lead` of them past a
// 16-byte boundary: element i of chunk j is plane element j * EPC - lead + i,
// each read by its clamped (h, w) and its channel; a chunk that reaches past
// either end of the plane writes only the plane's elements.
template <int ES>
__global__ void __launch_bounds__(kChunkThreads)
replication_pad_fwd_chunks_kernel(const unsigned char* __restrict__ x,
                                  unsigned char* __restrict__ y, const Geo p) {
  using U = typename Bits<ES>::U;
  constexpr int EPC = kVecBytes / ES;
  const int plane = blockIdx.x / p.plane_blocks, part = blockIdx.x - plane * p.plane_blocks;
  const int od = plane % p.Do, n = plane / p.Do;
  const int len = p.Ho * p.row.d;  // row.d: Wo x C
  const int64_t first = (int64_t)plane * len;
  const int lead = (int)(first & (EPC - 1));
  const int j = part * kChunkThreads + threadIdx.x, e0 = j * EPC - lead;
  if (e0 >= len) return;
  const U* src = reinterpret_cast<const U*>(x) +
                 ((int64_t)n * p.D + clampi(od - p.pd, p.D - 1)) * p.H * p.W * p.C;
  Chunk<ES> out;
#pragma unroll
  for (int i = 0; i < EPC; ++i) {
    const int e = e0 + i;
    U v = 0;
    if (e >= 0 && e < len) {
      const int oh = fdiv(p.row, e), k = e - oh * p.row.d;
      const int ow = fdiv(p.vox, k), c = k - ow * p.C;
      v = __ldg(src + ((int64_t)clampi(oh - p.ph, p.H - 1) * p.W + clampi(ow - p.pw, p.W - 1)) *
                          p.C + c);
    }
    out.e[i] = v;
  }
  unsigned char* dst = y + (first - lead + (int64_t)j * EPC) * ES;
  if (e0 >= 0 && e0 + EPC <= len) {
    *reinterpret_cast<uint4*>(dst) = out.v;
    return;
  }
#pragma unroll
  for (int i = 0; i < EPC; ++i)
    if (e0 + i >= 0 && e0 + i < len) reinterpret_cast<U*>(dst)[i] = out.e[i];
}

// ---------------------------------------------------------------------------
// backward: a block an input row

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ double widen(double v) { return v; }

template <typename T> __device__ __forceinline__ T narrow(typename Elem<T>::A v);
template <> __device__ __forceinline__ float narrow<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ double narrow<double>(double v) { return v; }

// One block an input row (n, d, h); its threads walk the row's W x C
// channels, VEC a thread (a 16-byte load a term where a voxel is whole
// units, else one element), each summing its fold straight from g.
template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
replication_pad_bwd_kernel(const T* __restrict__ g, T* __restrict__ dx, const Geo b) {
  using A = typename Elem<T>::A;
  using P = Pack<T, VEC>;
  const int units = b.C / VEC;
  const int row = blockIdx.x;  // (n, d, h)
  const int h = row % b.H;
  const int d = (row / b.H) % b.D;
  const int n = row / (b.H * b.D);
  const int od0 = fold_lo(d, b.pd), od1 = fold_hi(d, b.D, b.pd, b.Do);
  const int oh0 = fold_lo(h, b.ph), oh1 = fold_hi(h, b.H, b.ph, b.Ho);
  const P* gp = reinterpret_cast<const P*>(g);
  P* out = reinterpret_cast<P*>(dx) + (int64_t)row * b.W * units;
  const int len = b.W * units;
  for (int j = threadIdx.x; j < len; j += blockDim.x) {
    const int w = j / units, u = j - w * units;
    const int ow0 = fold_lo(w, b.pw), ow1 = fold_hi(w, b.W, b.pw, b.Wo);
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

// ---------------------------------------------------------------------------
// backward: the ring. Its tiles, their decode and the bulk-copy engine.

// an axis's first, middle and last class: first index and count
__device__ __forceinline__ void axis_class(int cls, int n, int* first, int* count) {
  *first = cls == 0 ? 0 : (cls == 1 ? 1 : n - 1);
  *count = cls == 0 ? 1 : (cls == 1 ? max(n - 2, 0) : (n >= 2 ? 1 : 0));
}

// tile t: the sample, then the depth class and its plane, then the row class,
// its row tile and the piece (replication_pad.py tile_at, step for step)
__device__ Tile tile_at(const Geo& p, const int* tab, int t) {
  Tile k;
  k.n = t / p.sample_tiles;
  int r = t - k.n * p.sample_tiles;
  int dc = 0, first = 0, count = 1;
  for (; dc < 2; ++dc) {
    axis_class(dc, p.D, &first, &count);
    const int span = count * tab[kPlaneTiles + dc];
    if (r < span) break;
    r -= span;
  }
  if (dc == 2) axis_class(2, p.D, &first, &count);
  const int q = r / tab[kPlaneTiles + dc];
  r -= q * tab[kPlaneTiles + dc];
  k.d = first + q;
  int hc = 0;
  for (; hc < 2; ++hc) {
    const int span = tab[kRowTiles + 3 * dc + hc] * tab[kPieces + 3 * dc + hc];
    if (r < span) break;
    r -= span;
  }
  axis_class(hc, p.H, &first, &count);
  const int cls = 3 * dc + hc, nw = tab[kPieces + cls], row = r / nw, wi = r - row * nw;
  k.h0 = first + row * tab[kRows + cls];
  k.h1 = min(k.h0 + tab[kRows + cls], first + count) - 1;
  k.w0 = wi * tab[kWidth + cls];
  k.w1 = min(k.w0 + tab[kWidth + cls], p.W) - 1;
  return k;
}

// keeps a value in a register: the compiler would otherwise reload it from
// the parameter bank inside the loops, a constant-cache miss a time
__device__ __forceinline__ void pin(int& r) { asm volatile("" : "+r"(r)); }
__device__ __forceinline__ void pin(uint32_t& r) { asm volatile("" : "+r"(r)); }

// the ring kernel's start: the scalars into registers, the tables into
// shared memory
__device__ __forceinline__ Geo kernel_start(const Plan& plan, int* tab) {
  if (threadIdx.x < kTable) tab[threadIdx.x] = plan.table[threadIdx.x];
  Geo g = plan.geo;
  for (int* v : {&g.N, &g.C, &g.D, &g.H, &g.W, &g.Do, &g.Ho, &g.Wo, &g.pd, &g.ph, &g.pw,
                 &g.stage_bytes, &g.stages, &g.tiles, &g.sample_tiles, &g.row.d, &g.vox.d})
    pin(*v);
  for (uint32_t* v : {&g.row.m, &g.row.s, &g.vox.m, &g.vox.s}) pin(*v);
  return g;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// one arrival that also tells the barrier how many bytes the copies bring
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// wait for the phase of the given parity to complete; a stage that has not
// landed after ~2^34 cycles (seconds) ends the kernel with an error rather
// than leave the card spinning
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

// bytes (a multiple of 16) from 16-byte aligned global memory into shared
// memory, counted on the barrier when they land
__device__ __forceinline__ void bulk_load(uint32_t dst, const unsigned char* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// the whole 16-byte units around [src, src + len): their first address and
// their bytes (a unit holding a byte of the tensor lies on its pages)
__device__ __forceinline__ uint32_t enclose(const unsigned char* src, int64_t len,
                                            const unsigned char** from) {
  const uintptr_t a = (uintptr_t)src & ~(uintptr_t)15;
  *from = reinterpret_cast<const unsigned char*>(a);
  return (uint32_t)((((uintptr_t)src + len + 15) & ~(uintptr_t)15) - a);
}

// bytes (a multiple of 16) from shared memory to 16-byte aligned global
// memory, in this thread's current bulk group
__device__ __forceinline__ void bulk_store(unsigned char* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst), "r"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// this thread's bulk stores but its newest group have read their shared
// memory (it may be refilled)
__device__ __forceinline__ void bulk_wait_read_all_but_one() {
  asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
}
// this thread's bulk stores are done
__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// A 16-byte load from shared memory by address, the staged rows read only
// so. Not volatile, so the compiler batches them ahead of the stores; the
// stage's address is passed through stage_ready after the wait for its
// copies, so no load moves above that wait.
__device__ __forceinline__ uint4 lds128(uint32_t a) {
  uint4 v;
  asm("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "r"(a));
  return v;
}
__device__ __forceinline__ uint32_t stage_ready(uint32_t stage) {
  asm volatile("" : "+r"(stage)::"memory");
  return stage;
}

// The gradient rows that fold into the tile, at every output depth of its
// fold range od0 .. od0 + nd - 1: rows fold_lo(h0)..fold_hi(h1), columns
// fold_lo(w0)..fold_hi(w1) of each plane. Depth i is staged at i * od_slot:
// whole rows in one copy (row r at the copy's skew + r * row bytes), a piece
// in one copy a row (row r at r * slot + its own skew).
struct Staged {
  const unsigned char* src;  // depth 0's row 0, first element, in g
  int64_t row_bytes, plane_bytes;
  int piece;    // bytes of a row's piece
  int slot;     // the stride of a piece's rows in the stage
  int od_slot;  // the stride of the depths in the stage
  int rows, nd, oh0, ow0;
  bool whole;
  __device__ __forceinline__ const unsigned char* row_src(int i, int r) const {
    return src + i * plane_bytes + r * row_bytes;
  }
  __device__ __forceinline__ uint32_t row_base(int i, int r) const {
    const uint32_t skew = (uint32_t)((uintptr_t)row_src(i, r) & 15);
    return (uint32_t)(i * od_slot) +
           (whole ? (uint32_t)((uintptr_t)row_src(i, 0) & 15) + (uint32_t)(r * row_bytes)
                  : (uint32_t)(r * slot) + skew);
  }
};

template <int ES>
__device__ __forceinline__ Staged bwd_staged(const Geo& p, const unsigned char* g,
                                             const Tile& k) {
  Staged s;
  const int od0 = fold_lo(k.d, p.pd);
  s.nd = fold_hi(k.d, p.D, p.pd, p.Do) - od0 + 1;
  s.oh0 = fold_lo(k.h0, p.ph);
  s.ow0 = fold_lo(k.w0, p.pw);
  s.rows = fold_hi(k.h1, p.H, p.ph, p.Ho) - s.oh0 + 1;
  s.whole = k.w0 == 0 && k.w1 == p.W - 1;
  s.row_bytes = (int64_t)p.Wo * p.C * ES;
  s.plane_bytes = s.row_bytes * p.Ho;
  s.piece = (fold_hi(k.w1, p.W, p.pw, p.Wo) - s.ow0 + 1) * p.C * ES;
  s.slot = (s.piece + 30) & ~15;
  s.od_slot = s.whole ? (int)(((s.rows - 1) * s.row_bytes + s.piece + 30) & ~15) : s.rows * s.slot;
  s.src = g + ((((int64_t)k.n * p.Do + od0) * p.Ho + s.oh0) * p.Wo + s.ow0) * p.C * ES;
  return s;
}

template <int ES>
__device__ __forceinline__ void bwd_issue(const Geo& p, const unsigned char* g, const Tile& k,
                                          uint32_t stage, uint32_t bar) {
  const Staged s = bwd_staged<ES>(p, g, k);
  const unsigned char* from;
  const int copies = s.whole ? 1 : s.rows;
  const int64_t len = s.whole ? (s.rows - 1) * s.row_bytes + s.piece : s.piece;
  uint32_t total = 0;
  for (int i = 0; i < s.nd; ++i)
    for (int r = 0; r < copies; ++r) total += enclose(s.row_src(i, r), len, &from);
  mbar_expect_tx(bar, total);
  for (int i = 0; i < s.nd; ++i)
    for (int r = 0; r < copies; ++r) {
      const uint32_t bytes = enclose(s.row_src(i, r), len, &from);
      bulk_load(stage + i * s.od_slot + r * s.slot, from, bytes, bar);
    }
}

// The EPC channels of one 16-byte unit: at each staged depth the staged rows
// r0 .. r1, each the W fold of its gn units from staged unit g0 on, a voxel
// apart; the rows folded in order, the depths folded in order.
template <typename T>
__device__ __forceinline__ void fold_unit(const Staged& s, uint32_t stage, int upv, int r0, int r1,
                                          int g0, int gn,
                                          typename Elem<T>::A (&acc_d)[kVecBytes / sizeof(T)]) {
  using E = Elem<T>;
  constexpr int ES = sizeof(T), EPC = kVecBytes / ES;
  for (int i = 0; i < s.nd; ++i) {
    typename E::A acc_h[EPC];
    for (int r = r0; r <= r1; ++r) {
      const uint32_t row = stage + s.row_base(i, r) + (uint32_t)(g0 * kVecBytes);
      Chunk<ES> t;
      t.v = lds128(row);
      typename E::A acc_w[EPC];
#pragma unroll
      for (int e = 0; e < EPC; ++e) acc_w[e] = E::widen(t.e[e]);
      for (int o = 1; o < gn; ++o) {
        t.v = lds128(row + (uint32_t)(o * upv * kVecBytes));
#pragma unroll
        for (int e = 0; e < EPC; ++e) acc_w[e] += E::widen(t.e[e]);
      }
#pragma unroll
      for (int e = 0; e < EPC; ++e) acc_h[e] = r == r0 ? acc_w[e] : acc_h[e] + acc_w[e];
    }
#pragma unroll
    for (int e = 0; e < EPC; ++e) acc_d[e] = i == 0 ? acc_h[e] : acc_d[e] + acc_h[e];
  }
}

// The tile where every row's D and H folds are one term (a middle plane's
// middle rows): a row's inner voxels (one W term each) are its staged
// gradient row, widened and rounded back to the same bits, so one bulk store
// each (warp 0's lanes, a row each); the threads sum the edge voxels' W
// folds. False where the tile has rows of several terms.
template <typename T>
__device__ __forceinline__ bool bwd_units(const Geo& p, const Staged& s, const Tile& k,
                                          uint32_t stage, unsigned char* dx) {
  using E = Elem<T>;
  constexpr int ES = sizeof(T), EPC = kVecBytes / ES;
  const int rows = k.h1 - k.h0 + 1, wa = max(k.w0, 1), wb = min(k.w1, p.W - 2);
  if (s.nd != 1 || s.rows != rows || wa > wb) return false;
  const int upv = p.vox.d, left = (wa - k.w0) * upv, right = (k.w1 - wb) * upv;
  const int64_t row_units = (int64_t)p.W * upv;
  uint4* out0 = reinterpret_cast<uint4*>(dx) +
                (((int64_t)k.n * p.D + k.d) * p.H + k.h0) * row_units + (int64_t)k.w0 * upv;
  if (threadIdx.x < 32) {  // warp 0's lanes issue a row each
    for (int r = threadIdx.x; r < rows; r += 32)
      bulk_store(reinterpret_cast<unsigned char*>(out0 + r * row_units + left),
                 stage + s.row_base(0, r) + (uint32_t)((wa + p.pw - s.ow0) * upv * kVecBytes),
                 (uint32_t)((wb - wa + 1) * upv * kVecBytes));
    bulk_commit();
  }
  const int edge = left + right;
  for (int q = threadIdx.x; q < rows * edge; q += kRingThreads) {
    const int r = q / edge, e = q - r * edge, side = e < left ? 0 : 1, eu = e - side * left;
    const int wr = fdiv(p.vox, eu), u = eu - wr * upv;
    const int w = side ? wb + 1 + wr : k.w0 + wr, lo = fold_lo(w, p.pw);
    typename E::A acc[EPC];
    fold_unit<T>(s, stage, upv, r, r, (lo - s.ow0) * upv + u, fold_hi(w, p.W, p.pw, p.Wo) - lo + 1,
                 acc);
    Chunk<ES> o;
#pragma unroll
    for (int i = 0; i < EPC; ++i) o.e[i] = E::narrow(acc[i]);
    out0[r * row_units + eu + side * (left + (wb - wa + 1) * upv)] = o.v;
  }
  return true;
}

// The tile's input gradient from its staged rows: each 16-byte unit summed
// whole by one thread, rounded once and stored.
template <typename T>
__device__ __forceinline__ void bwd_store(const Geo& p, const unsigned char* g, unsigned char* dx,
                                          const Tile& k, uint32_t stage) {
  using E = Elem<T>;
  constexpr int ES = sizeof(T), EPC = kVecBytes / ES;
  const Staged s = bwd_staged<ES>(p, g, k);
  if (bwd_units<T>(p, s, k, stage, dx)) return;
  const int upv = p.vox.d, len = ((k.h1 - k.h0) * p.W + (k.w1 - k.w0 + 1)) * upv;
  uint4* dst = reinterpret_cast<uint4*>(dx) +
               (((int64_t)k.n * p.D + k.d) * p.H + k.h0) * p.W * upv + (int64_t)k.w0 * upv;
  for (int j = threadIdx.x; j < len; j += kRingThreads) {
    const int r = fdiv(p.row, j), kk = j - r * p.row.d, h = k.h0 + r;
    const int r0 = fold_lo(h, p.ph) - s.oh0, r1 = fold_hi(h, p.H, p.ph, p.Ho) - s.oh0;
    const int wr = fdiv(p.vox, kk), w = k.w0 + wr, lo = fold_lo(w, p.pw);
    typename E::A acc[EPC];
    fold_unit<T>(s, stage, upv, r0, r1, (lo - s.ow0) * upv + kk - wr * upv,
                 fold_hi(w, p.W, p.pw, p.Wo) - lo + 1, acc);
    Chunk<ES> out;
#pragma unroll
    for (int e = 0; e < EPC; ++e) out.e[e] = E::narrow(acc[e]);
    dst[j] = out.v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kRingThreads)
replication_pad_bwd_ring_kernel(const unsigned char* __restrict__ g, unsigned char* __restrict__ dx,
                                const __grid_constant__ Plan plan) {
  constexpr int ES = sizeof(T);
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ int tab[kTable];
  __shared__ Tile slot[kMaxStages];  // the tile each stage holds
  const Geo p = kernel_start(plan, tab);
  const uint32_t ring0 = smem_u32(ring), full0 = smem_u32(full);
  // block b walks tiles b, b + G, b + 2G, ...: at any time the grid works on
  // neighbouring tiles, so the memory streams stay close together
  const int G = gridDim.x, mine = (p.tiles - blockIdx.x + G - 1) / G;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) mbar_init(full0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // thread 0 decodes tile i of the block into stage i % stages' slot, then
  // loads it; the barrier's completion carries the slot to the other threads
  auto load = [&](int i, int s) {
    const Tile k = tile_at(p, tab, blockIdx.x + i * G);
    slot[s] = k;
    bwd_issue<ES>(p, g, k, ring0 + s * p.stage_bytes, full0 + 8 * s);
  };
  if (threadIdx.x == 0)
    for (int s = 0; s < p.stages && s < mine; ++s) load(s, s);
  for (int i = 0; i < mine; ++i) {
    const int s = i % p.stages;
    mbar_wait(full0 + 8 * s, (i / p.stages) & 1);
    const Tile k = slot[s];
    bwd_store<T>(p, g, dx, k, stage_ready(ring0 + s * p.stage_bytes));
    __syncthreads();  // the threads have read the stage
    // refill the previous tile's stage once its bulk stores have read it too,
    // so a refill never waits on the stores just issued
    const int prev = (i + p.stages - 1) % p.stages;
    if (threadIdx.x < 32 && i > 0 && i - 1 + p.stages < mine) {
      bulk_wait_read_all_but_one();  // every lane's stores
      __syncwarp();
      if (threadIdx.x == 0) load(i - 1 + p.stages, prev);
    }
  }
  if (threadIdx.x < 32) bulk_wait();
}

// ---------------------------------------------------------------------------
// host side

int elem_bytes(int dtype) {
  switch (dtype) {
    case DT_F32: return 4;
    case DT_BF16: return 2;
    case DT_F64: return 8;
    default: return 0;
  }
}

// The parameter array (replication_pad.py PARAMS): dtype, vec, route,
// threads, grid, then the Plan field by field.
constexpr int kHeader = 5;

// The checks: every size positive, the output box the input grown by the
// pads, vec 1 or a 16-byte unit dividing a voxel; per route, the block and
// the grid (a row kernel's a block a destination row; the chunk kernel's
// plane_blocks an output plane, covering its chunks; the ring's stages in
// shared memory, its grid covered by the tiles).
const Plan* checked_plan(const int* p, int es, bool backward) {
  const Plan* plan = reinterpret_cast<const Plan*>(p + kHeader);
  const Geo* q = &plan->geo;
  const int vec = p[1], route = p[2], threads = p[3], grid = p[4];
  if (es == 0 || q->N < 1 || q->C < 1 || q->D < 1 || q->H < 1 || q->W < 1) return nullptr;
  if (q->pd < 0 || q->ph < 0 || q->pw < 0 || q->Do < q->D + q->pd || q->Ho < q->H + q->ph ||
      q->Wo < q->W + q->pw)
    return nullptr;
  if (!(vec == 1 || (vec * es == kVecBytes && (q->C * es) % kVecBytes == 0))) return nullptr;
  if (grid < 1) return nullptr;
  if (route == ROUTE_ROWS) {
    const int64_t rows = backward ? (int64_t)q->N * q->D * q->H : (int64_t)q->N * q->Do * q->Ho;
    if (threads < 32 || threads > kMaxThreads || threads % 32 || grid != rows) return nullptr;
    return backward || vec > 1 ? plan : nullptr;  // the forward's row kernel moves units
  }
  if (route == ROUTE_CHUNKS) {
    const int64_t len = (int64_t)q->Ho * q->Wo * q->C, epc = kVecBytes / es;
    if (backward || threads != kChunkThreads || q->plane_blocks < 1 || len > 0x7fffffff ||
        q->row.d != q->Wo * q->C || q->vox.d != q->C ||
        (int64_t)q->plane_blocks * kChunkThreads * epc < len + epc - 1 ||
        (int64_t)grid != (int64_t)q->N * q->Do * q->plane_blocks)
      return nullptr;
    return plan;
  }
  if (route != ROUTE_RING || !backward || vec == 1 || threads != kRingThreads) return nullptr;
  if (q->stages < 1 || q->stages > kMaxStages || q->stage_bytes < 16 || q->stage_bytes % 16 ||
      (int64_t)q->stage_bytes * q->stages > kSmemLimit)
    return nullptr;
  if (grid > q->tiles || q->sample_tiles < 1 || q->row.d < 1 || q->vox.d < 1) return nullptr;
  for (int i = 0; i < kTable; ++i)  // counts of tiles may be 0, the tile sizes not
    if (plan->table[i] < (i >= kRows && i < kRowTiles ? 1 : 0)) return nullptr;
  return plan;
}

// the dynamic shared memory each ring kernel may take so far
int g_ring_smem[3] = {48 * 1024, 48 * 1024, 48 * 1024};

template <typename T>
cudaError_t launch_ring(int* allowed, const void* g, void* dx, const Plan& plan, int grid,
                        cudaStream_t s) {
  const int smem = plan.geo.stage_bytes * plan.geo.stages;
  if (smem > *allowed) {
    const cudaError_t e = cudaFuncSetAttribute(replication_pad_bwd_ring_kernel<T>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    *allowed = smem;
  }
  replication_pad_bwd_ring_kernel<T><<<grid, kRingThreads, smem, s>>>(
      static_cast<const unsigned char*>(g), static_cast<unsigned char*>(dx), plan);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_rows_bwd(const void* g, void* dx, const Geo& b, int grid, int threads,
                            cudaStream_t s) {
  replication_pad_bwd_kernel<T, VEC><<<grid, threads, 0, s>>>(static_cast<const T*>(g),
                                                              static_cast<T*>(dx), b);
  return cudaGetLastError();
}

template <int ES>
cudaError_t launch_chunks(const void* x, void* y, const Geo& b, int grid, cudaStream_t s) {
  replication_pad_fwd_chunks_kernel<ES><<<grid, kChunkThreads, 0, s>>>(
      static_cast<const unsigned char*>(x), static_cast<unsigned char*>(y), b);
  return cudaGetLastError();
}

bool aligned(const void* a) { return ((uintptr_t)a & (kVecBytes - 1)) == 0; }

}  // namespace

extern "C" {

const char* mra_pad_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// the multiprocessors of a device, or minus a CUDA error
int mra_pad_sms(int device) {
  int sms = 0;
  const cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return e == cudaSuccess ? sms : -(int)e;
}

// p: the launch's parameters (replication_pad.py launch_plan). mra_pad_fwd:
// x (N, D, H, W, C) -> y (N, D + pd0 + pd1, H + ph0 + ph1, W + pw0 + pw1, C).
int mra_pad_fwd(const void* x, void* y, const int* p, void* stream) {
  const int es = elem_bytes(p[0]);
  const Plan* q = checked_plan(p, es, false);
  const bool vec = p[1] > 1;
  if (q == nullptr || !aligned(y) || (vec && !aligned(x))) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geo& b = q->geo;
  if (p[2] == ROUTE_ROWS) {
    replication_pad_fwd_kernel<<<p[4], p[3], 0, s>>>(static_cast<const uint4*>(x),
                                                     static_cast<uint4*>(y), b, b.vox.d);
    return (int)cudaGetLastError();
  }
  switch (es) {
    case 2: return (int)launch_chunks<2>(x, y, b, p[4], s);
    case 4: return (int)launch_chunks<4>(x, y, b, p[4], s);
    default: return (int)launch_chunks<8>(x, y, b, p[4], s);
  }
}

// g (N, Do, Ho, Wo, C), the output gradient of mra_pad_fwd with the same
// pads -> dx (N, D, H, W, C).
int mra_pad_bwd(const void* g, void* dx, const int* p, void* stream) {
  const Plan* q = checked_plan(p, elem_bytes(p[0]), true);
  const bool vec = p[1] > 1;
  if (q == nullptr || (vec && !(aligned(g) && aligned(dx)))) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geo& b = q->geo;
  const int grid = p[4], threads = p[3];
  if (p[2] == ROUTE_RING) {
    switch (p[0]) {
      case DT_F32: return (int)launch_ring<float>(&g_ring_smem[0], g, dx, *q, grid, s);
      case DT_BF16: return (int)launch_ring<__nv_bfloat16>(&g_ring_smem[1], g, dx, *q, grid, s);
      default: return (int)launch_ring<double>(&g_ring_smem[2], g, dx, *q, grid, s);
    }
  }
  switch (p[0]) {
    case DT_F32:
      return (int)(vec ? launch_rows_bwd<float, 4>(g, dx, b, grid, threads, s)
                       : launch_rows_bwd<float, 1>(g, dx, b, grid, threads, s));
    case DT_BF16:
      return (int)(vec ? launch_rows_bwd<__nv_bfloat16, 8>(g, dx, b, grid, threads, s)
                       : launch_rows_bwd<__nv_bfloat16, 1>(g, dx, b, grid, threads, s));
    default:
      return (int)(vec ? launch_rows_bwd<double, 2>(g, dx, b, grid, threads, s)
                       : launch_rows_bwd<double, 1>(g, dx, b, grid, threads, s));
  }
}

}  // extern "C"
