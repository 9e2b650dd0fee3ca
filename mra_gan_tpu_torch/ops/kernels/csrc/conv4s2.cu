// The PatchGAN's first conv, Conv3d(1, C, 4, stride=2, padding=p) with a zero
// pad p of 0 or 1 on each axis, forward, input gradient and weight gradient,
// for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package computes this conv with XLA on
// the TPU, rewritten for the MXU as a stride-1 conv over space-to-depth cells
// (conv3d_s2d_stride2, mra_gan_tpu/ops/s2d.py:618; models/networks.py:229).
// On the card the port left it to cuDNN, whose generic implicit-GEMM kernel
// took ~1.2 ms a call for a conv that moves ~42 MB at N = 16. The same
// convs are the U-Net's outermost down conv (no bias; depth pad 0 on a
// depth shard under --spatial_shard).
//
// Layout. x and dx are (N, 1, D, H, W): one channel, so NDHW in memory. y
// and g are (N, C, Do, Ho, Wo) in channels_last_3d (NDHWC in memory): the C
// channels of a voxel are contiguous. w is (C, 64), the taps t = 16 kd + 4 kh
// + kw of each channel. Do = (D + 2 pd - 4) / 2 + 1 (Ho, Wo alike); voxels
// outside a box read as zero. Every product is bf16 x bf16, summed in float32
// by mma.sync.m16n8k16 (row.col, f32 accumulators), rounded once.
//
// conv4s2_spread (forward): y[n, c, o] = bias[c] + sum_t w[c, t] x[n, 2o + t - p]
//   (the staged kernel; the TMA kernel keeps its products, 8 consumer warps).
//   One block of 4 warps a tile of TD x TH x TW outputs (TW <= 32). The tile's
//   input window, (2TD + 2) x (2TH + 2) rows of 2TW + 2 voxels, is staged in
//   shared memory once: neighbouring outputs share half their window on each
//   axis. A warp takes 16 outputs at a time (the M of the product, the tile's
//   outputs in z, y, x order); the 64 taps are K, four k-steps, one a kd;
//   the channels N, four n-tiles of 8 a chunk of 32. An A register is two
//   taps (kw, kw + 1) of one output: the row is staged from x index
//   2 ow0 - pw, so that pair is one aligned 32-bit word. The row pitch (96
//   bf16, 48 words, 16 mod 32) keeps a warp's A loads free of bank conflicts.
//   The weights of a chunk sit in registers as B fragments for the whole
//   block. The sums go through a per-warp staging tile (80-byte voxels,
//   conflict-free) so that the stores are 16-byte channel vectors where
//   C % 8 == 0 (else one element a thread).
//
// conv4s2_gather (input gradient): dx[n, i] = sum_c sum_t w[c, t] g[n, c, o]
//   with o = (i + p - t) / 2 where that is whole and inside the output box.
//   Along an axis write i + p = 2q + r (the cell q, the parity r): then t =
//   r + 2 f and o = q - f for f in {0, 1}. So the 2 x 2 x 2 voxels of a cell
//   read the same 8 output voxels, and the gradient of a cell is a product
//   with M = cells, K = 8 offsets f x C channels and N = the 8 parities r:
//   B[(f, c), r] = w[c, r + 2f] (per axis), which every voxel owns, so there
//   are no atomics. A block stages the g voxels of a tile of TD x TH x TW
//   cells (TD TH TW <= 320) and their one-voxel low halo (80-byte voxels) a
//   chunk of 32 channels at a time, with 16-byte loads where C % 8 == 0; a
//   warp keeps up to 5 m-tiles' sums across the chunks.
//
// conv4s2_wgrad (weight and bias gradient), first pass (staged kernel below;
// its TMA kernel keeps the M, N, K and the one-row bias):
//   dw[c, t] = sum_n sum_o g[n, c, o] x[n, 2o + t - p], db[c] = sum g[n, c, o].
//   M = the 64 taps and a 65th row whose input is 1 (the bias), N = 32
//   channels (a grid row a chunk), K = the output voxels, 16 along a row a
//   k-step. The input window of a tile is staged as four planes, plane kw
//   holding x[2j + kw] of output j, so the two voxels of an A register are one
//   aligned word (plane pitch 72 bf16, 36 words: a warp's loads hit 32
//   distinct banks). g is staged as 80-byte voxels and read by
//   ldmatrix.x4.trans straight into B fragments. A fixed grid of blocks
//   (min(tiles, 528), a function of the shape alone) walks the tiles in a
//   fixed order; each block adds its 4 warps' sums in warp order and writes
//   one float32 partial (65 x 32 a chunk).
// conv4s2_wgrad_reduce, second pass: each output (65 rows x C) sums the
//   partials p = w, w + 8, ... in order in warp w, then the 8 warps in order,
//   and rounds once: dw (C, 64) and db (C). Nothing depends on the order in
//   which blocks run, so a train step's weight gradients are the same in
//   every run (ops/kernels/conv4s2.py repeats the reduce's order in its plain
//   version).
//
// Bound: memory. At N = 16 and C = 32 the forward reads 8.4 MB and writes
// 33.6 MB, the weight gradient reads the same two (~12.5 us at 3.35 TB/s);
// their 2.15 GFLOP take ~2 us on the tensor cores. The staged kernels above
// load with plain loads and wait at __syncthreads before every tile's
// products, so nothing of one tile overlaps the next within a block.
//
// The TMA path (conv4s2_spread_tma, conv4s2_wgrad_tma): the same tiles and
// products, fed by the Tensor Memory Accelerator. A persistent grid (at most
// one block an SM, a function of the shape alone) walks the tiles b, b +
// grid, ...; in each block one producer warp keeps a ring of stages in
// flight (cp.async.bulk.tensor, completion counted in bytes on a full
// mbarrier, each stage freed by an empty one) while 8 consumer warps
// multiply the stage that has landed. The input window is one box of a
// 4-d map over x (W, H, D, N): its zero pad and every voxel past the box
// come as TMA's zero fill. A box's innermost coordinate must be a multiple
// of 16 bytes, negative or not (x index -1 or 1 faults at run time with an
// illegal instruction on an H100; 0, 8 and -8 load), so a window row
// starts at a multiple of 8 voxels and the window e0 in [-1, 7] voxels into
// it; A registers are made from two words by a byte permute where a pair
// straddles them, and x[-1] (the low pad) is masked to zero. The forward
// holds the weights in registers for the whole walk, writes each tile's
// sums into one of two output tiles (64-byte voxels under the 64-byte
// swizzle) and stores it by TMA, which clips at the box and runs on while
// the next tile loads and multiplies. The weight gradient's g tile comes by
// TMA under the same swizzle, read by ldmatrix.trans without bank conflicts.
//
// The path: TMA where the maps can describe every tensor (x's rows a
// multiple of 16 bytes: W % 8 == 0; y or g with C % 8 == 0; every source
// 16-byte aligned), else the staged kernels; ops/kernels/conv4s2.py
// (takes_tma, launch_params) decides from the shape and the alignment
// alone, once a shape. The gather has the staged kernel only.
//
// C interface (ctypes, ops/kernels/conv4s2.py): each launcher takes its
// parameters as one int array worked out once a shape on the host ({N, C,
// D, H, W, pd, ph, pw, TD, TH, TW, vec, grid, tma, pitch}), launches the
// path it names on the caller's stream and returns a cudaError_t.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <initializer_list>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;             // 4 warps a block (all three first passes)
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 32;                // channels a chunk
constexpr int kTaps = 64;
constexpr int kRows = kTaps + 1;          // a weight-gradient partial: the taps, then the bias
constexpr int kVox = 40;                  // bf16 a staged voxel of a chunk (32 + 8: 80 bytes)
constexpr int kSpreadRow = 96;            // bf16 a staged input row of the spread
constexpr int kPlane = 72;                // bf16 a staged plane of the weight gradient
constexpr int kMaxTileW = 32;             // spread and weight gradient: outputs along W a tile
constexpr int kMaxCells = 320;            // gather: cells a tile
constexpr int kGatherMaxW = 40;           // gather: cells along W a tile
constexpr int kGatherMT = kMaxCells / 16 / kWarps;  // m-tiles a warp of the gather
constexpr int kReduceWarps = 8;
constexpr uint32_t kOnes = 0x3F803F80u;   // two bf16 ones
// the TMA path (conv4s2_spread_tma, conv4s2_wgrad_tma)
constexpr int kSpreadWarps = 8;           // consumer warps of the TMA forward, a producer besides
constexpr int kSpreadThreads = 32 * (kSpreadWarps + 1);
constexpr int kWgradWarps = 8;            // and of the TMA weight gradient
constexpr int kWgradThreads = 32 * (kWgradWarps + 1);
constexpr int kSpreadMPW = 4;             // m-tiles a consumer warp of the TMA forward at most
constexpr int kSlot = 64;                 // bytes a voxel of a 32-channel chunk in a TMA tile
constexpr int kSpreadStages = 2;          // spread: input windows in flight a block
constexpr int kWgradStages = 3;           // weight gradient: (window, g tile) pairs in flight
constexpr int kAlign = 1024;              // a TMA buffer's alignment (the 64-byte swizzle's)

struct Geo {
  int N, C;
  int D, H, W;       // the one-channel field's box (x, dx)
  int Od, Oh, Ow;    // the C-channel field's box (y, g)
  int pd, ph, pw;    // the low (and high) zero pads
  int TD, TH, TW;    // a tile: outputs (spread, weight gradient) or cells (gather)
  int nd, nh, nw;    // tiles a sample along each axis
  int vec;           // g or y moved in 16-byte channel vectors
};

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// a: the shared-memory address of this lane's row
__device__ __forceinline__ void ldsm_x4_trans(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                              uint32_t& r3, uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                              uint32_t& r3, const bf16* p) {
  ldsm_x4_trans(r0, r1, r2, r3, static_cast<uint32_t>(__cvta_generic_to_shared(p)));
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t bits(bf16 v) { return __bfloat16_as_ushort(v); }

__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ bool inside(int i, int n) { return i >= 0 && i < n; }

// Tile t of a sample-major walk: its sample and its origin (in tiles' units
// times the tile).
__device__ __forceinline__ void tile_origin(const Geo& g, int t, int& n, int& a, int& b,
                                            int& c) {
  c = t % g.nw;
  t /= g.nw;
  b = t % g.nh;
  t /= g.nh;
  a = t % g.nd;
  n = t / g.nd;
  a *= g.TD;
  b *= g.TH;
  c *= g.TW;
}

// ---------------------------------------------------------------------------
// Hopper's asynchronous pieces: mbarriers and TMA (as csrc/conv7.cu has them)

__host__ __device__ __forceinline__ int round_up(int v, int m) { return (v + m - 1) / m * m; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// one arrival that also tells the barrier how many bytes TMA will bring
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

// wait for the phase of the given parity to complete
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// threads' writes to shared memory made visible to TMA
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4),
      "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_store_5d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5, %6}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(c4)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// every TMA store but the newest N has read its tile out of shared memory
template <int N>
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// byte offset of 16-byte chunk q (8 channels) of voxel u in a TMA tile of
// 64-byte voxels under the 64-byte swizzle: the chunk index XOR-ed with bits
// 1-2 of u (address bits, so a tile starts on kAlign bytes). The 8 voxels of
// an ldmatrix phase, or of a warp's accumulator stores, fall in 8 distinct
// 16-byte bank groups.
__device__ __forceinline__ int chunk_offset(int u, int q) {
  return u * kSlot + ((q ^ ((u >> 1) & 3)) << 4);
}

// The TMA path's window rows start at x index window_x0(w0) for a window
// whose first voxel is x index w0 = 2 ow0 - pw: a box's first coordinate
// stays a non-negative multiple of 8 voxels (16 bytes), which the tensor
// copy requires of the innermost one; the window's first voxel then sits
// e0 = w0 - window_x0(w0) in [-1, 7] voxels into the row, e0 = -1 being the
// low zero pad. The rows above and below the box (negative y, z included)
// come as TMA's zero fill.
__host__ __device__ __forceinline__ int window_x0(int w0) { return w0 < 0 ? 0 : (w0 & ~7); }

// Two voxels of a staged row as one A register from the words at p and p +
// d (p word-aligned): bytes picked by `sel`. The forward's pair (x[e], x[e +
// 1]) is the word at e (d = 0, sel 0x3210) where e is even, else the halves
// of those at e - 1 and e + 1 (d = 2, 0x5432); the weight gradient's (x[e],
// x[e + 2]) the low (e even, 0x5410) or high (e odd, 0x7632) halves of the
// words at e & ~1 and 2 on. The caller masks x[-1], the pad, to zero.
__device__ __forceinline__ uint32_t pair_at(const bf16* p, int d, uint32_t sel) {
  return __byte_perm(lds32(p), lds32(p + d), sel);
}

// Stage a window of the one-channel field: rows (z0 + zz, y0 + yy), zz < RD,
// yy < RH, row r = zz RH + yy, a warp a row; along a row, kPlanes planes of
// width RW / kPlanes: plane kw, entry j holds x[x0 + kStep j + kw] (one plane
// of step 1: the row as it is; four of step 2: the weight gradient's) at
// dst[r pitch + kw plane + j], zero outside the box. kCols >= RW / 32 entries
// a lane; a warp loads kRows rows before it stores any.
template <int kPlanes, int kCols, int kRows>
__device__ __forceinline__ void stage_rows(const bf16* __restrict__ xn, const Geo& g, int z0,
                                           int y0, int x0, int RD, int RH, int RW, bf16* dst,
                                           int pitch, int plane) {
  constexpr int kStep = kPlanes > 1 ? 2 : 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, rows = RD * RH;
  for (int r0 = warp; r0 < rows; r0 += kRows * kWarps) {
    bf16 v[kRows][kCols];
#pragma unroll
    for (int h = 0; h < kRows; ++h) {
      const int r = r0 + h * kWarps, iz = z0 + r / RH, iy = y0 + r % RH;
      const bool row_in = r < rows && inside(iz, g.D) && inside(iy, g.H);
      const bf16* src = xn + ((int64_t)iz * g.H + iy) * g.W;
#pragma unroll
      for (int m = 0; m < kCols; ++m) {
        const int k = lane + 32 * m, ix = x0 + kStep * (k / kPlanes) + k % kPlanes;
        v[h][m] = __ushort_as_bfloat16(0);
        if (row_in && k < RW && inside(ix, g.W)) v[h][m] = src[ix];
      }
    }
#pragma unroll
    for (int h = 0; h < kRows; ++h) {
      const int r = r0 + h * kWarps;
#pragma unroll
      for (int m = 0; m < kCols; ++m) {
        const int k = lane + 32 * m;
        if (r < rows && k < RW) dst[r * pitch + (k % kPlanes) * plane + k / kPlanes] = v[h][m];
      }
    }
  }
}

// Stage rows of a C-channel field (y or g, NDHWC), a chunk of 32 channels:
// for r < rows, a warp a row, the voxels (od0 + r / RH, oh0 + r % RH, ow0 +
// j), j < RW, to dst[(r RW + j) kVox + c], zero outside the box, past wmax
// along the row or past C. 16-byte vectors where g.vec (kCols >= RW / 8 a
// lane, a warp loading kRows rows before it stores any), else elements.
template <int kCols, int kRows>
__device__ __forceinline__ void stage_voxels(const bf16* __restrict__ gn, const Geo& g, int c0,
                                             int od0, int oh0, int ow0, int rows, int RH,
                                             int RW, int wmax, bf16* dst) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (!g.vec) {
    for (int r = warp; r < rows; r += kWarps) {
      const int od = od0 + r / RH, oh = oh0 + r % RH;
      const bool row_in = inside(od, g.Od) && inside(oh, g.Oh);
      const bf16* src = gn + (((int64_t)od * g.Oh + oh) * g.Ow) * g.C + c0;
      for (int k = lane; k < RW * kGroup; k += 32) {
        const int j = k >> 5, c = k & 31, ow = ow0 + j;
        dst[(r * RW + j) * kVox + c] = row_in && j < wmax && inside(ow, g.Ow) && c0 + c < g.C
                                           ? src[(int64_t)ow * g.C + c]
                                           : __ushort_as_bfloat16(0);
      }
    }
    return;
  }
  for (int r0 = warp; r0 < rows; r0 += kRows * kWarps) {
    uint4 v[kRows][kCols];
#pragma unroll
    for (int h = 0; h < kRows; ++h) {
      const int r = r0 + h * kWarps, od = od0 + r / RH, oh = oh0 + r % RH;
      const bool row_in = r < rows && inside(od, g.Od) && inside(oh, g.Oh);
      const bf16* src = gn + (((int64_t)od * g.Oh + oh) * g.Ow) * g.C + c0;
#pragma unroll
      for (int m = 0; m < kCols; ++m) {
        const int k = lane + 32 * m, j = k >> 2, c = 8 * (k & 3), ow = ow0 + j;
        v[h][m] = make_uint4(0u, 0u, 0u, 0u);
        if (row_in && j < RW && j < wmax && inside(ow, g.Ow) && c0 + c < g.C)
          v[h][m] = *reinterpret_cast<const uint4*>(src + (int64_t)ow * g.C + c);
      }
    }
#pragma unroll
    for (int h = 0; h < kRows; ++h) {
      const int r = r0 + h * kWarps;
#pragma unroll
      for (int m = 0; m < kCols; ++m) {
        const int k = lane + 32 * m, j = k >> 2;
        if (r < rows && j < RW)
          *reinterpret_cast<uint4*>(dst + (r * RW + j) * kVox + 8 * (k & 3)) = v[h][m];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// forward

__global__ void __launch_bounds__(kThreads)
conv4s2_spread_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                      const bf16* __restrict__ bias, bf16* __restrict__ y, Geo g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int RD = 2 * g.TD + 2, RH = 2 * g.TH + 2, RW = 2 * g.TW + 2;
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* stage = xs + RD * RH * kSpreadRow;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  int n, od0, oh0, ow0;
  tile_origin(g, blockIdx.x, n, od0, oh0, ow0);

  stage_rows<1, (2 * kMaxTileW + 2 + 31) / 32, 4>(
      x + (int64_t)n * g.D * g.H * g.W, g, 2 * od0 - g.pd, 2 * oh0 - g.ph, 2 * ow0 - g.pw, RD, RH,
      RW, xs, kSpreadRow, 0);
  __syncthreads();

  const int V = g.TD * g.TH * g.TW, M = (V + 15) >> 4;
  bf16* st = stage + warp * 16 * kVox;
  const int kofs = (tq >> 1) * kSpreadRow + 2 * (tq & 1);  // taps 2tq, 2tq + 1 of a k-step
  for (int c0 = 0; c0 < g.C; c0 += kGroup) {
    uint32_t b[4][4][2];
    float bv[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int c = c0 + 8 * nt + gq;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const bf16* wp = w + (int64_t)c * kTaps + 16 * s + 2 * tq;
        b[s][nt][0] = c < g.C ? *reinterpret_cast<const uint32_t*>(wp) : 0u;
        b[s][nt][1] = c < g.C ? *reinterpret_cast<const uint32_t*>(wp + 8) : 0u;
      }
      const int cb = c0 + 8 * nt + 2 * tq;
      bv[nt][0] = bias != nullptr && cb < g.C ? __bfloat162float(bias[cb]) : 0.f;
      bv[nt][1] = bias != nullptr && cb + 1 < g.C ? __bfloat162float(bias[cb + 1]) : 0.f;
    }
    for (int mt = warp; mt < M; mt += kWarps) {
      int base[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int v = 16 * mt + gq + 8 * h;
        v = v < V ? v : V - 1;
        const int vw = v % g.TW, rr = v / g.TW, vh = rr % g.TH, vd = rr / g.TH;
        base[h] = (2 * vd * RH + 2 * vh) * kSpreadRow + 2 * vw + kofs;
      }
      float acc[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
      for (int s = 0; s < 4; ++s) {  // kd = s; a0, a1 kh = tq >> 1, a2, a3 two rows on
        const int o = s * RH * kSpreadRow;
        const uint32_t a0 = lds32(xs + base[0] + o), a1 = lds32(xs + base[1] + o);
        const uint32_t a2 = lds32(xs + base[0] + o + 2 * kSpreadRow);
        const uint32_t a3 = lds32(xs + base[1] + o + 2 * kSpreadRow);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[nt], a0, a1, a2, a3, b[s][nt][0], b[s][nt][1]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = 8 * nt + 2 * tq;
        *reinterpret_cast<uint32_t*>(st + gq * kVox + col) =
            pack_rn(acc[nt][0] + bv[nt][0], acc[nt][1] + bv[nt][1]);
        *reinterpret_cast<uint32_t*>(st + (gq + 8) * kVox + col) =
            pack_rn(acc[nt][2] + bv[nt][0], acc[nt][3] + bv[nt][1]);
      }
      __syncwarp();
      const int units = g.vec ? 4 : kGroup;  // 16-byte vectors or elements a voxel
      for (int piece = lane; piece < 16 * units; piece += 32) {
        const int r = g.vec ? piece >> 2 : piece >> 5;
        const int k = g.vec ? 8 * (piece & 3) : piece & 31;
        const int v = 16 * mt + r;
        if (v >= V || c0 + k >= g.C) continue;
        const int vw = v % g.TW, rr = v / g.TW, vh = rr % g.TH, vd = rr / g.TH;
        const int od = od0 + vd, oh = oh0 + vh, ow = ow0 + vw;
        if (od >= g.Od || oh >= g.Oh || ow >= g.Ow) continue;
        const int64_t at = ((((int64_t)n * g.Od + od) * g.Oh + oh) * g.Ow + ow) * g.C + c0 + k;
        if (g.vec)
          *reinterpret_cast<uint4*>(y + at) = *reinterpret_cast<const uint4*>(st + r * kVox + k);
        else
          y[at] = st[r * kVox + k];
      }
      __syncwarp();
    }
  }
}

// The forward on the TMA path: the same products as conv4s2_spread_kernel,
// fed and drained by TMA. A persistent block walks tiles blockIdx.x, +
// gridDim.x, ...; its producer warp keeps kSpreadStages input windows in
// flight (a box of (2TD + 2) x (2TH + 2) rows of `pitch` voxels from x index
// (window_x0(2 ow0 - pw), 2 oh0 - ph, 2 od0 - pd) of sample n: the zero pad
// and every voxel past the box come as TMA's zero fill), each stage guarded
// by a full and an empty mbarrier. The 8 consumer warps hold the weights' B fragments
// in registers for the whole walk (C <= 32; else reloaded a chunk), write a
// tile's rounded sums into one of two output tiles in shared memory (64-byte
// voxels under the 64-byte swizzle) and hand it to one TMA store, which
// clips at the output box and runs on while the next tile loads and
// multiplies; a buffer is written again once the store two tiles back has
// read it (cp.async.bulk.wait_group.read 1).
__global__ void __launch_bounds__(kSpreadThreads)
conv4s2_spread_tma_kernel(const __grid_constant__ CUtensorMap x_map,
                          const __grid_constant__ CUtensorMap y_map, const bf16* __restrict__ w,
                          const bf16* __restrict__ bias, Geo g, int pitch, int tiles) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((kAlign - (smem_u32(smem_raw) & (kAlign - 1))) & (kAlign - 1));
  const int RD = 2 * g.TD + 2, RH = 2 * g.TH + 2;
  const int V = g.TD * g.TH * g.TW, M = (V + 15) >> 4;
  const int out_bytes = round_up(V * kSlot, kAlign);
  const int x_bytes = round_up(RD * RH * pitch * 2, kAlign);
  unsigned char* outb = smem;                 // two output tiles
  unsigned char* xb = smem + 2 * out_bytes;   // kSpreadStages input windows
  uint64_t* bars = reinterpret_cast<uint64_t*>(xb + kSpreadStages * x_bytes);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + kSpreadStages);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSpreadStages; ++s) {
      mbar_init(full0 + 8 * s, 1);                    // the producer's expect-tx arrival
      mbar_init(empty0 + 8 * s, kSpreadWarps * 32);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kSpreadWarps) {  // the producer
    if (lane == 0) {
      int k = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++k) {
        int n, od0, oh0, ow0;
        tile_origin(g, t, n, od0, oh0, ow0);
        const int s = k % kSpreadStages;
        mbar_wait(empty0 + 8 * s, ((k / kSpreadStages) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, RD * RH * pitch * 2);
        tma_load_4d(smem_u32(xb + s * x_bytes), &x_map, full0 + 8 * s,
                    window_x0(2 * ow0 - g.pw), 2 * oh0 - g.ph, 2 * od0 - g.pd, n);
      }
    }
    return;
  }

  const int gq = lane >> 2, tq = lane & 3;
  // this lane's outputs, the same in every tile: rows gq and gq + 8 of m-tiles
  // warp, warp + kSpreadWarps, ...; an A register is taps (kw, kw + 1), kw =
  // 2 (tq & 1), of kernel row kh = tq >> 1 (a0, a1; a2, a3 two rows on): x[2
  // vw + kw - pw], at woff + e0 in the stage (e0 the tile's window offset).
  // vox: the output voxel (-1 past the tile), first: taps 0, 1 of output vw
  // = 0, whose x[-1] is the low pad where e0 = -1
  int woff[kSpreadMPW][2], vox[kSpreadMPW][2];
  uint32_t first = 0;
#pragma unroll
  for (int i = 0; i < kSpreadMPW; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int v = 16 * (warp + kSpreadWarps * i) + gq + 8 * h, vc = v < V ? v : V - 1;
      const int vw = vc % g.TW, rr = vc / g.TW, vh = rr % g.TH, vd = rr / g.TH;
      woff[i][h] = (2 * vd * RH + 2 * vh + (tq >> 1)) * pitch + 2 * vw + 2 * (tq & 1);
      vox[i][h] = v < V ? v : -1;
      if (vw == 0 && (tq & 1) == 0) first |= 1u << (2 * i + h);
    }
  uint32_t b[4][4][2];
  float bv[4][2];
  auto load_weights = [&](int c0) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int c = c0 + 8 * nt + gq;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const bf16* wp = w + (int64_t)c * kTaps + 16 * s + 2 * tq;
        b[s][nt][0] = c < g.C ? *reinterpret_cast<const uint32_t*>(wp) : 0u;
        b[s][nt][1] = c < g.C ? *reinterpret_cast<const uint32_t*>(wp + 8) : 0u;
      }
      const int cb = c0 + 8 * nt + 2 * tq;
      bv[nt][0] = bias != nullptr && cb < g.C ? __bfloat162float(bias[cb]) : 0.f;
      bv[nt][1] = bias != nullptr && cb + 1 < g.C ? __bfloat162float(bias[cb + 1]) : 0.f;
    }
  };
  const bool one_chunk = g.C <= kGroup;
  if (one_chunk) load_weights(0);
  // the window's offset e0 has the parity of pw in every tile: a pair is one
  // word (pw = 0) or the halves of two (pw = 1)
  const int odd = g.pw & 1, d = 2 * odd;
  const uint32_t sel = odd ? 0x5432u : 0x3210u;
  int k = 0, u = 0;  // tiles walked, output tiles stored
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++k) {
    int n, od0, oh0, ow0;
    tile_origin(g, t, n, od0, oh0, ow0);
    const int s = k % kSpreadStages;
    const int e0 = 2 * ow0 - g.pw - window_x0(2 * ow0 - g.pw);
    const uint32_t pad = e0 == -1 ? 0xFFFF0000u : 0xFFFFFFFFu;
    mbar_wait(full0 + 8 * s, (k / kSpreadStages) & 1);
    const bf16* xs = reinterpret_cast<const bf16*>(xb + s * x_bytes) + e0 - odd;
    for (int c0 = 0; c0 < g.C; c0 += kGroup, ++u) {
      if (!one_chunk) load_weights(c0);
      unsigned char* ob = outb + (u & 1) * out_bytes;
      if (threadIdx.x == 0) tma_store_wait_read<1>();  // the store two tiles back has read ob
      bar_sync(1, kSpreadWarps * 32);
#pragma unroll
      for (int i = 0; i < kSpreadMPW; ++i) {
        if (warp + kSpreadWarps * i >= M) break;
        const bf16* p0 = xs + woff[i][0];
        const bf16* p1 = xs + woff[i][1];
        const uint32_t m0 = (first >> (2 * i)) & 1 ? pad : 0xFFFFFFFFu;
        const uint32_t m1 = (first >> (2 * i + 1)) & 1 ? pad : 0xFFFFFFFFu;
        float acc[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
        for (int kd = 0; kd < 4; ++kd) {
          const int o = kd * RH * pitch;
          const uint32_t a0 = pair_at(p0 + o, d, sel) & m0, a1 = pair_at(p1 + o, d, sel) & m1;
          const uint32_t a2 = pair_at(p0 + o + 2 * pitch, d, sel) & m0;
          const uint32_t a3 = pair_at(p1 + o + 2 * pitch, d, sel) & m1;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_bf16(acc[nt], a0, a1, a2, a3, b[kd][nt][0], b[kd][nt][1]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int v = vox[i][h];
          if (v < 0) continue;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            *reinterpret_cast<uint32_t*>(ob + chunk_offset(v, nt) + 4 * tq) =
                pack_rn(acc[nt][2 * h] + bv[nt][0], acc[nt][2 * h + 1] + bv[nt][1]);
        }
      }
      if (c0 + kGroup >= g.C) mbar_arrive(empty0 + 8 * s);  // the window is read
      fence_proxy_async();
      bar_sync(1, kSpreadWarps * 32);
      if (threadIdx.x == 0) tma_store_5d(&y_map, smem_u32(ob), c0, ow0, oh0, od0, n);
    }
  }
  if (threadIdx.x == 0) tma_store_wait();
}

// ---------------------------------------------------------------------------
// input gradient

__global__ void __launch_bounds__(kThreads)
conv4s2_gather_kernel(const bf16* __restrict__ gr, const bf16* __restrict__ w,
                      bf16* __restrict__ dx, Geo g) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* gs = reinterpret_cast<bf16*>(smem);
  const int SH = g.TH + 1, SW = g.TW + 1, rows = (g.TD + 1) * SH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  int n, qd0, qh0, qw0;
  tile_origin(g, blockIdx.x, n, qd0, qh0, qw0);
  const int V = g.TD * g.TH * g.TW, M = (V + 15) >> 4;

  // the staged voxel (element offset) of each of a lane's two cells, rows gq
  // and gq + 8 of its m-tiles, at offset f = 0: the tile's voxel o = q is at
  // q - q0 + 1 (the low halo first)
  int sv[kGatherMT][2];
#pragma unroll
  for (int i = 0; i < kGatherMT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int v = 16 * (warp + i * kWarps) + gq + 8 * h;
      v = v < V ? v : V - 1;
      const int cw = v % g.TW, rr = v / g.TW, ch = rr % g.TH, cd = rr / g.TH;
      sv[i][h] = (((cd + 1) * SH + ch + 1) * SW + cw + 1) * kVox;
    }
  }
  float acc[kGatherMT][4];
#pragma unroll
  for (int i = 0; i < kGatherMT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const bf16* gn = gr + (int64_t)n * g.Od * g.Oh * g.Ow * g.C;
  const int rd = gq >> 2, rh = (gq >> 1) & 1, rw = gq & 1;  // the parity of B's column gq
  for (int c0 = 0; c0 < g.C; c0 += kGroup) {
    __syncthreads();  // the previous chunk's reads are done
    stage_voxels<(4 * (kGatherMaxW + 1) + 31) / 32, 1>(gn, g, c0, qd0 - 1, qh0 - 1, qw0 - 1,
                                                       rows, SH, SW, SW, gs);
    // B[(f, c), r] = w[c, r + 2f]: k-step s is offset f = s >> 1 (bits fd fh fw),
    // channels 16 (s & 1) + 0..15 of the chunk
    uint32_t b[16][2];
#pragma unroll
    for (int s = 0; s < 16; ++s) {
      const int f = s >> 1;
      const int tap = (rd + 2 * (f >> 2)) * 16 + (rh + 2 * ((f >> 1) & 1)) * 4 + rw + 2 * (f & 1);
      const int c = c0 + 16 * (s & 1) + 2 * tq;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int cc = c + 8 * half;
        const uint32_t lo = cc < g.C ? bits(w[(int64_t)cc * kTaps + tap]) : 0u;
        const uint32_t hi = cc + 1 < g.C ? bits(w[(int64_t)(cc + 1) * kTaps + tap]) : 0u;
        b[s][half] = lo | (hi << 16);
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kGatherMT; ++i) {
      if (warp + i * kWarps < M) {
#pragma unroll
        for (int s = 0; s < 16; ++s) {
          const int f = s >> 1;
          const int k = 16 * (s & 1) + 2 * tq - (((f >> 2) * SH + ((f >> 1) & 1)) * SW + (f & 1)) * kVox;
          const uint32_t a0 = lds32(gs + sv[i][0] + k), a1 = lds32(gs + sv[i][1] + k);
          const uint32_t a2 = lds32(gs + sv[i][0] + k + 8), a3 = lds32(gs + sv[i][1] + k + 8);
          mma_bf16(acc[i], a0, a1, a2, a3, b[s][0], b[s][1]);
        }
      }
    }
  }

  // a lane holds, for each of its cells, the parities n = 2tq + e: rd = tq >> 1,
  // rh = tq & 1, rw = e, the voxels i = 2q - p + r
  bf16* dn = dx + (int64_t)n * g.D * g.H * g.W;
#pragma unroll
  for (int i = 0; i < kGatherMT; ++i) {
    const int mt = warp + i * kWarps;
    if (mt >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int v = 16 * mt + gq + 8 * h;
      if (v >= V) continue;
      const int cw = v % g.TW, rr = v / g.TW, ch = rr % g.TH, cd = rr / g.TH;
      const int id = 2 * (qd0 + cd) - g.pd + (tq >> 1), ih = 2 * (qh0 + ch) - g.ph + (tq & 1);
      const int iw = 2 * (qw0 + cw) - g.pw;
      if (!inside(id, g.D) || !inside(ih, g.H)) continue;
      bf16* row = dn + ((int64_t)id * g.H + ih) * g.W;
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (inside(iw + e, g.W)) row[iw + e] = __float2bfloat16_rn(acc[i][2 * h + e]);
    }
  }
}

// ---------------------------------------------------------------------------
// weight and bias gradient

__global__ void __launch_bounds__(kThreads)
conv4s2_wgrad_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gr,
                     float* __restrict__ partial, Geo g, int grid) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int RD = 2 * g.TD + 2, RH = 2 * g.TH + 2, KW = (g.TW + 15) >> 4, TWr = 16 * KW;
  const int planes = 4 * kPlane;  // bf16 a staged input row: its four planes
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* gs = xs + RD * RH * planes;
  float* red = reinterpret_cast<float*>(smem);  // after the walk: kWarps x kRows x kGroup
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int c0 = blockIdx.y * kGroup;
  const int tiles = g.N * g.nd * g.nh * g.nw;

  float acc[5][4][4];
#pragma unroll
  for (int m = 0; m < 5; ++m)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) acc[m][nt][0] = acc[m][nt][1] = acc[m][nt][2] = acc[m][nt][3] = 0.f;
  // A row gq is tap 16 kd + gq (kh = gq >> 2, kw = gq & 3): plane kw of row 2vh + kh
  const int aoff = gq * kPlane + 2 * tq;
  const int mi = lane >> 3;  // ldmatrix: the matrix whose row this lane addresses
  const int boff = ((mi & 1) * 8 + (lane & 7)) * kVox + (mi >> 1) * 8;
  const uint32_t one = gq == 0 ? kOnes : 0u;

  for (int t = blockIdx.x; t < tiles; t += grid) {
    int n, od0, oh0, ow0;
    tile_origin(g, t, n, od0, oh0, ow0);
    __syncthreads();  // the previous tile's reads are done
    stage_rows<4, 4 * kMaxTileW / 32, 2>(x + (int64_t)n * g.D * g.H * g.W, g, 2 * od0 - g.pd,
                                          2 * oh0 - g.ph, 2 * ow0 - g.pw, RD, RH, 4 * TWr, xs,
                                          planes, kPlane);
    stage_voxels<kMaxTileW / 8, 1>(gr + (int64_t)n * g.Od * g.Oh * g.Ow * g.C, g, c0, od0, oh0,
                                   ow0, g.TD * g.TH, g.TH, TWr, g.TW, gs);
    __syncthreads();
    for (int r = warp; r < g.TD * g.TH; r += kWarps) {
      const int vd = r / g.TH, vh = r % g.TH;
      for (int ks = 0; ks < KW; ++ks) {
        uint32_t b[4][2];
        const bf16* bp = gs + (r * TWr + 16 * ks) * kVox + boff;
        ldsm_x4_trans(b[0][0], b[0][1], b[1][0], b[1][1], bp);
        ldsm_x4_trans(b[2][0], b[2][1], b[3][0], b[3][1], bp + 16);
        const bf16* ap = xs + (2 * vd * RH + 2 * vh) * planes + aoff + 16 * ks;
#pragma unroll
        for (int kd = 0; kd < 4; ++kd) {
          const bf16* p = ap + kd * RH * planes;
          const uint32_t a0 = lds32(p), a1 = lds32(p + 8 * kPlane);
          const uint32_t a2 = lds32(p + 8), a3 = lds32(p + 8 * kPlane + 8);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[kd][nt], a0, a1, a2, a3, b[nt][0], b[nt][1]);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[4][nt], one, 0u, one, 0u, b[nt][0], b[nt][1]);
      }
    }
  }

  __syncthreads();
  float* mine = red + warp * kRows * kGroup;
#pragma unroll
  for (int kd = 0; kd < 4; ++kd)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int tap = 16 * kd + gq, ch = 8 * nt + 2 * tq;
      mine[tap * kGroup + ch] = acc[kd][nt][0];
      mine[tap * kGroup + ch + 1] = acc[kd][nt][1];
      mine[(tap + 8) * kGroup + ch] = acc[kd][nt][2];
      mine[(tap + 8) * kGroup + ch + 1] = acc[kd][nt][3];
    }
  if (gq == 0)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      mine[kTaps * kGroup + 8 * nt + 2 * tq] = acc[4][nt][0];
      mine[kTaps * kGroup + 8 * nt + 2 * tq + 1] = acc[4][nt][1];
    }
  __syncthreads();
  const int Cp = gridDim.y * kGroup;
  float* out = partial + (int64_t)blockIdx.x * kRows * Cp + c0;
  for (int e = threadIdx.x; e < kRows * kGroup; e += kThreads) {
    float s = red[e];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) s += red[k * kRows * kGroup + e];
    out[(e / kGroup) * Cp + e % kGroup] = s;
  }
}

// The first pass on the TMA path: the same sums as conv4s2_wgrad_kernel.
// A persistent block (grid fixed by the shape) walks tiles blockIdx.x, +
// gridDim.x, ... of channel chunk blockIdx.y; its producer warp keeps
// kWgradStages (input window, g tile) pairs in flight, both by TMA: the
// window as rows of `pitch` voxels (zero pad and past-the-box voxels as
// zero fill), the g tile as TD x TH rows of TWr = 16 ceil(TW / 16) 64-byte
// voxels of the chunk under the 64-byte swizzle, which ldmatrix.trans reads
// without bank conflicts. A row of the window holds x[2j + kw] and x[2j + 2 +
// kw] of the two outputs j, j + 1 of an A register in two aligned words;
// one byte permute makes the register, so x is read from device memory
// once a window. Voxels j >= TW of a g row (the next tile's, where TWr > TW)
// meet zeroed A halves, so each output voxel is summed by one tile. The
// walk, the warps' rows and the k order are fixed by the shape, so each
// partial sums in a fixed order.
__global__ void __launch_bounds__(kWgradThreads)
conv4s2_wgrad_tma_kernel(const __grid_constant__ CUtensorMap x_map,
                         const __grid_constant__ CUtensorMap g_map, float* __restrict__ partial,
                         Geo g, int pitch, int tiles) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((kAlign - (smem_u32(smem_raw) & (kAlign - 1))) & (kAlign - 1));
  const int RD = 2 * g.TD + 2, RH = 2 * g.TH + 2, KW = (g.TW + 15) >> 4, TWr = 16 * KW;
  const int x_bytes = round_up(RD * RH * pitch * 2, kAlign);
  const int g_bytes = round_up(g.TD * g.TH * TWr * kSlot, kAlign);
  const int stage = x_bytes + g_bytes;  // the window, then the g tile
  unsigned char* ring = smem + kAlign;  // past a guard: a window's x[-1] reads stay in bounds
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + kWgradStages * stage);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + kWgradStages);
  float* red = reinterpret_cast<float*>(smem);  // after the walk: kWgradWarps x kRows x kGroup
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = blockIdx.y * kGroup;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgradStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kWgradWarps * 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[5][4][4];
#pragma unroll
  for (int m = 0; m < 5; ++m)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) acc[m][nt][0] = acc[m][nt][1] = acc[m][nt][2] = acc[m][nt][3] = 0.f;

  if (warp == kWgradWarps) {  // the producer
    if (lane == 0) {
      int k = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++k) {
        int n, od0, oh0, ow0;
        tile_origin(g, t, n, od0, oh0, ow0);
        const int s = k % kWgradStages;
        const uint32_t full = full0 + 8 * s;
        mbar_wait(empty0 + 8 * s, ((k / kWgradStages) & 1) ^ 1);
        mbar_expect_tx(full, RD * RH * pitch * 2 + g.TD * g.TH * TWr * kSlot);
        unsigned char* st = ring + s * stage;
        tma_load_4d(smem_u32(st), &x_map, full, window_x0(2 * ow0 - g.pw), 2 * oh0 - g.ph,
                    2 * od0 - g.pd, n);
        tma_load_5d(smem_u32(st + x_bytes), &g_map, full, c0, ow0, oh0, od0, n);
      }
    }
    __syncwarp();
  } else {
    const int gq = lane >> 2, tq = lane & 3;
    // A row gq is tap 16 kd + gq (kh = gq >> 2, kw = gq & 3): its pair of a
    // k-step, outputs j and j + 1, is x[2j + kw - pw] and the voxel 2 on, e =
    // e0 + 2j + kw voxels into window row 2vh + kh
    const int mi = lane >> 3;  // ldmatrix: the matrix whose row this lane addresses
    const int brow = (mi & 1) * 8 + (lane & 7), bq = mi >> 1;
    int k = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++k) {
      int n, od0, oh0, ow0;
      tile_origin(g, t, n, od0, oh0, ow0);
      // the lane's first pair (output j = 2tq at ks = 0) sits e voxels into
      // its row; a k-step on, 32; a2's, 16
      const int e = 2 * ow0 - g.pw - window_x0(2 * ow0 - g.pw) + (gq & 3) + 4 * tq;
      const uint32_t sel = (e & 1) ? 0x7632u : 0x5410u;
      const uint32_t pad = e == -1 ? 0xFFFF0000u : 0xFFFFFFFFu;  // x[-1]: a0, a1 of k-step 0
      const int s = k % kWgradStages;
      mbar_wait(full0 + 8 * s, (k / kWgradStages) & 1);
      const bf16* xs = reinterpret_cast<const bf16*>(ring + s * stage) + (e & ~1);
      const uint32_t gs = smem_u32(ring + s * stage + x_bytes);
      for (int r = warp; r < g.TD * g.TH; r += kWgradWarps) {
        const int vd = r / g.TH, vh = r % g.TH;
        const bf16* ar = xs + (2 * vd * RH + 2 * vh + (gq >> 2)) * pitch;
        for (int ks = 0; ks < KW; ++ks) {
          const int j = 16 * ks + 2 * tq;  // the outputs of a0's (and a1's) k pair; a2's 8 on
          const uint32_t v0 = (j < g.TW ? 0xFFFFu : 0u) | (j + 1 < g.TW ? 0xFFFF0000u : 0u);
          const uint32_t m2 = (j + 8 < g.TW ? 0xFFFFu : 0u) | (j + 9 < g.TW ? 0xFFFF0000u : 0u);
          const uint32_t m0 = v0 & (ks == 0 ? pad : 0xFFFFFFFFu);  // and the pad's x[-1]
          uint32_t b[4][2];
          const int u = r * TWr + 16 * ks + brow;
          ldsm_x4_trans(b[0][0], b[0][1], b[1][0], b[1][1], gs + chunk_offset(u, bq));
          ldsm_x4_trans(b[2][0], b[2][1], b[3][0], b[3][1], gs + chunk_offset(u, bq + 2));
#pragma unroll
          for (int kd = 0; kd < 4; ++kd) {
            const bf16* p = ar + kd * RH * pitch + 32 * ks;
            const uint32_t a0 = pair_at(p, 2, sel) & m0;
            const uint32_t a1 = pair_at(p + 2 * pitch, 2, sel) & m0;
            const uint32_t a2 = pair_at(p + 16, 2, sel) & m2;
            const uint32_t a3 = pair_at(p + 2 * pitch + 16, 2, sel) & m2;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[kd][nt], a0, a1, a2, a3, b[nt][0], b[nt][1]);
          }
          const uint32_t one0 = gq == 0 ? kOnes & v0 : 0u, one2 = gq == 0 ? kOnes & m2 : 0u;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[4][nt], one0, 0u, one2, 0u, b[nt][0], b[nt][1]);
        }
      }
      mbar_arrive(empty0 + 8 * s);  // the stage is read
    }
  }

  __syncthreads();  // every stage consumed: the ring becomes the warps' sums
  if (warp < kWgradWarps) {
    float* mine = red + warp * kRows * kGroup;
#pragma unroll
    for (int kd = 0; kd < 4; ++kd)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int gq = lane >> 2, tq = lane & 3, tap = 16 * kd + gq, ch = 8 * nt + 2 * tq;
        mine[tap * kGroup + ch] = acc[kd][nt][0];
        mine[tap * kGroup + ch + 1] = acc[kd][nt][1];
        mine[(tap + 8) * kGroup + ch] = acc[kd][nt][2];
        mine[(tap + 8) * kGroup + ch + 1] = acc[kd][nt][3];
      }
    if ((lane >> 2) == 0)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        mine[kTaps * kGroup + 8 * nt + 2 * lane] = acc[4][nt][0];
        mine[kTaps * kGroup + 8 * nt + 2 * lane + 1] = acc[4][nt][1];
      }
  }
  __syncthreads();
  const int Cp = gridDim.y * kGroup;
  float* out = partial + (int64_t)blockIdx.x * kRows * Cp + c0;
  for (int e = threadIdx.x; e < kRows * kGroup; e += kWgradThreads) {
    float s = red[e];
#pragma unroll
    for (int q = 1; q < kWgradWarps; ++q) s += red[q * kRows * kGroup + e];
    out[(e / kGroup) * Cp + e % kGroup] = s;
  }
}

__global__ void __launch_bounds__(kReduceWarps * 32)
conv4s2_wgrad_reduce_kernel(const float* __restrict__ partial, bf16* __restrict__ dw,
                            bf16* __restrict__ db, int P, int C, int Cp) {
  __shared__ float sums[kReduceWarps][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int total = kRows * Cp, e = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (e < total)
    for (int p = warp; p < P; p += kReduceWarps) s += partial[(int64_t)p * total + e];
  sums[warp][lane] = s;
  __syncthreads();
  if (warp != 0 || e >= total) return;
  float v = sums[0][lane];
#pragma unroll
  for (int k = 1; k < kReduceWarps; ++k) v += sums[k][lane];
  const int row = e / Cp, c = e % Cp;
  if (c >= C) return;
  if (row < kTaps)
    dw[(int64_t)c * kTaps + row] = __float2bfloat16_rn(v);
  else if (db != nullptr)
    db[c] = __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------------------
// host side

int cdiv(int a, int b) { return (a + b - 1) / b; }

// p = {N, C, D, H, W, pd, ph, pw, TD, TH, TW, vec}; cells: whether the tile
// counts cells (the gather) or outputs
bool make_geo(Geo* g, const int* p, bool cells) {
  *g = Geo{};
  g->N = p[0];
  g->C = p[1];
  g->D = p[2];
  g->H = p[3];
  g->W = p[4];
  g->pd = p[5];
  g->ph = p[6];
  g->pw = p[7];
  g->TD = p[8];
  g->TH = p[9];
  g->TW = p[10];
  g->vec = p[11];
  g->Od = (g->D + 2 * g->pd - 4) / 2 + 1;
  g->Oh = (g->H + 2 * g->ph - 4) / 2 + 1;
  g->Ow = (g->W + 2 * g->pw - 4) / 2 + 1;
  if (g->N < 1 || g->C < 1 || g->TD < 1 || g->TH < 1 || g->TW < 1) return false;
  for (int pad : {g->pd, g->ph, g->pw})
    if (pad != 0 && pad != 1) return false;
  if (g->D + 2 * g->pd < 4 || g->H + 2 * g->ph < 4 || g->W + 2 * g->pw < 4) return false;
  if (g->vec && g->C % 8 != 0) return false;
  const int span_d = cells ? (g->D - 1 + g->pd) / 2 + 1 : g->Od;
  const int span_h = cells ? (g->H - 1 + g->ph) / 2 + 1 : g->Oh;
  const int span_w = cells ? (g->W - 1 + g->pw) / 2 + 1 : g->Ow;
  if (cells ? g->TD * g->TH * g->TW > kMaxCells || g->TW > kGatherMaxW : g->TW > kMaxTileW)
    return false;
  g->nd = cdiv(span_d, g->TD);
  g->nh = cdiv(span_h, g->TH);
  g->nw = cdiv(span_w, g->TW);
  return (int64_t)g->N * g->nd * g->nh * g->nw <= 0x7fffffff;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int* allowed) {
  if (bytes <= *allowed) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) *allowed = bytes;
  return e;
}

int g_spread_smem = 48 * 1024, g_gather_smem = 48 * 1024, g_wgrad_smem = 48 * 1024;
int g_spread_tma_smem = 48 * 1024, g_wgrad_tma_smem = 48 * 1024;

int spread_smem(const Geo& g) {
  return ((2 * g.TD + 2) * (2 * g.TH + 2) * kSpreadRow + kWarps * 16 * kVox) * 2;
}
int gather_smem(const Geo& g) { return (g.TD + 1) * (g.TH + 1) * (g.TW + 1) * kVox * 2; }
int wgrad_smem(const Geo& g) {
  const int tiles = ((2 * g.TD + 2) * (2 * g.TH + 2) * 4 * kPlane +
                     g.TD * g.TH * 16 * cdiv(g.TW, 16) * kVox) * 2;
  const int red = kWarps * kRows * kGroup * 4;
  return tiles > red ? tiles : red;
}

// the TMA path: an input window's bytes (rows of `pitch` voxels), and a
// block's shared memory, the alignment slack and the barriers included
int window_bytes(const Geo& g, int pitch) {
  return round_up((2 * g.TD + 2) * (2 * g.TH + 2) * pitch * 2, kAlign);
}
int spread_tma_smem(const Geo& g, int pitch) {
  return kAlign + 2 * round_up(g.TD * g.TH * g.TW * kSlot, kAlign) +
         kSpreadStages * window_bytes(g, pitch) + 2 * kSpreadStages * 8;
}
int wgrad_tma_smem(const Geo& g, int pitch) {
  const int ring = kWgradStages * (window_bytes(g, pitch) +
                                   round_up(g.TD * g.TH * 16 * cdiv(g.TW, 16) * kSlot, kAlign));
  const int red = kWgradWarps * kRows * kGroup * 4;  // the warps' sums, over the ring at the end
  return 2 * kAlign + (ring > red ? ring : red) + 2 * kWgradStages * 8;  // and the guard
}

// cuTensorMapEncodeTiled from the driver, found at run time (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// A bf16 tensor map: dims innermost first, the byte strides of dims 1..rank-1
// (multiples of 16), the box, zeros outside the tensor. Any CUresult but
// success (a base or stride TMA cannot take) is an invalid value.
cudaError_t make_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                     const cuuint64_t* strides, const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
                        dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// x (N, 1, D, H, W) as a 4-d map (W, H, D, N), its box one input window of
// `pitch` x (2TH + 2) x (2TD + 2) voxels
cudaError_t window_map(CUtensorMap* map, const void* x, const Geo& g, int pitch) {
  const cuuint64_t row = (cuuint64_t)g.W * 2;
  const cuuint64_t dims[4] = {(cuuint64_t)g.W, (cuuint64_t)g.H, (cuuint64_t)g.D, (cuuint64_t)g.N};
  const cuuint64_t strides[3] = {row, row * g.H, row * g.H * g.D};
  const cuuint32_t box[4] = {(cuuint32_t)pitch, (cuuint32_t)(2 * g.TH + 2),
                             (cuuint32_t)(2 * g.TD + 2), 1};
  return make_map(map, x, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

// y or g (N, Od, Oh, Ow, C) as a 5-d map (C, Ow, Oh, Od, N), its box a chunk
// of 32 channels of tw x TH x TD voxels, under the 64-byte swizzle
cudaError_t voxel_map(CUtensorMap* map, const void* t, const Geo& g, int tw) {
  const cuuint64_t row = (cuuint64_t)g.C * 2;
  const cuuint64_t dims[5] = {(cuuint64_t)g.C, (cuuint64_t)g.Ow, (cuuint64_t)g.Oh,
                              (cuuint64_t)g.Od, (cuuint64_t)g.N};
  const cuuint64_t strides[4] = {row, row * g.Ow, row * g.Ow * g.Oh, row * g.Ow * g.Oh * g.Od};
  const cuuint32_t box[5] = {kGroup, (cuuint32_t)tw, (cuuint32_t)g.TH, (cuuint32_t)g.TD, 1};
  return make_map(map, t, 5, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_64B);
}

// the TMA path's checks: what the maps need (W and C multiples of 8; the
// bases' alignment the encode checks), a window row that holds `need`
// voxels, and a grid of at most the tiles
bool tma_ok(const Geo& g, int grid, int pitch, int need) {
  const int tiles = g.N * g.nd * g.nh * g.nw;
  return g.W % 8 == 0 && g.C % 8 == 0 && grid >= 1 && grid <= tiles && pitch >= need &&
         pitch % 8 == 0 && pitch <= 256;
}

}  // namespace

extern "C" {

const char* mra_conv4s2_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// x (N, 1, D, H, W), w (C, 64), bias (C) or null -> y (N, Do, Ho, Wo, C);
// p[12] the grid, p[13] the path (1: TMA), p[14] the window's row pitch.
int mra_conv4s2_spread(const void* x, const void* w, const void* bias, void* y, const int* p,
                       void* stream) {
  Geo g;
  if (!make_geo(&g, p, false)) return (int)cudaErrorInvalidValue;
  if (p[13]) {
    const int grid = p[12], pitch = p[14];
    if (!tma_ok(g, grid, pitch, 2 * g.TW + 10) ||
        g.TD * g.TH * g.TW > 16 * kSpreadMPW * kSpreadWarps)
      return (int)cudaErrorInvalidValue;
    CUtensorMap x_map, y_map;
    memset(&x_map, 0, sizeof(x_map));
    memset(&y_map, 0, sizeof(y_map));
    cudaError_t e = window_map(&x_map, x, g, pitch);
    if (e == cudaSuccess) e = voxel_map(&y_map, y, g, g.TW);
    const int smem = spread_tma_smem(g, pitch);
    if (e == cudaSuccess) e = allow_smem(conv4s2_spread_tma_kernel, smem, &g_spread_tma_smem);
    if (e != cudaSuccess) return (int)e;
    conv4s2_spread_tma_kernel<<<(unsigned)grid, kSpreadThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
        x_map, y_map, static_cast<const bf16*>(w), static_cast<const bf16*>(bias), g, pitch,
        g.N * g.nd * g.nh * g.nw);
    return (int)cudaGetLastError();
  }
  const int smem = spread_smem(g);
  cudaError_t e = allow_smem(conv4s2_spread_kernel, smem, &g_spread_smem);
  if (e != cudaSuccess) return (int)e;
  conv4s2_spread_kernel<<<(unsigned)(g.N * g.nd * g.nh * g.nw), kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const bf16*>(bias),
      static_cast<bf16*>(y), g);
  return (int)cudaGetLastError();
}

// g (N, Do, Ho, Wo, C), w (C, 64) -> dx (N, 1, D, H, W); the tile in cells.
int mra_conv4s2_gather(const void* gr, const void* w, void* dx, const int* p, void* stream) {
  Geo g;
  if (!make_geo(&g, p, true)) return (int)cudaErrorInvalidValue;
  const int smem = gather_smem(g);
  cudaError_t e = allow_smem(conv4s2_gather_kernel, smem, &g_gather_smem);
  if (e != cudaSuccess) return (int)e;
  conv4s2_gather_kernel<<<(unsigned)(g.N * g.nd * g.nh * g.nw), kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(gr), static_cast<const bf16*>(w), static_cast<bf16*>(dx), g);
  return (int)cudaGetLastError();
}

// x (N, 1, D, H, W), g (N, Do, Ho, Wo, C) -> partial (grid, 65, 32 * chunks)
// float32; p[12] the grid (at most the tiles), p[13] the path (1: TMA),
// p[14] the window's row pitch.
int mra_conv4s2_wgrad(const void* x, const void* gr, void* partial, const int* p, void* stream) {
  Geo g;
  if (!make_geo(&g, p, false)) return (int)cudaErrorInvalidValue;
  const int grid = p[12];
  if (p[13]) {
    const int pitch = p[14], twr = 16 * cdiv(g.TW, 16);
    if (!tma_ok(g, grid, pitch, 2 * twr + 12)) return (int)cudaErrorInvalidValue;
    CUtensorMap x_map, g_map;
    memset(&x_map, 0, sizeof(x_map));
    memset(&g_map, 0, sizeof(g_map));
    cudaError_t e = window_map(&x_map, x, g, pitch);
    if (e == cudaSuccess) e = voxel_map(&g_map, gr, g, twr);
    const int smem = wgrad_tma_smem(g, pitch);
    if (e == cudaSuccess) e = allow_smem(conv4s2_wgrad_tma_kernel, smem, &g_wgrad_tma_smem);
    if (e != cudaSuccess) return (int)e;
    conv4s2_wgrad_tma_kernel<<<dim3((unsigned)grid, (unsigned)cdiv(g.C, kGroup)), kWgradThreads,
                               smem, static_cast<cudaStream_t>(stream)>>>(
        x_map, g_map, static_cast<float*>(partial), g, pitch, g.N * g.nd * g.nh * g.nw);
    return (int)cudaGetLastError();
  }
  if (grid < 1 || grid > g.N * g.nd * g.nh * g.nw) return (int)cudaErrorInvalidValue;
  const int smem = wgrad_smem(g);
  cudaError_t e = allow_smem(conv4s2_wgrad_kernel, smem, &g_wgrad_smem);
  if (e != cudaSuccess) return (int)e;
  conv4s2_wgrad_kernel<<<dim3((unsigned)grid, (unsigned)cdiv(g.C, kGroup)), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(gr), static_cast<float*>(partial), g,
      grid);
  return (int)cudaGetLastError();
}

// partial (P, 65, Cp) -> dw (C, 64), db (C) or null; p = {P, C, Cp}.
int mra_conv4s2_wgrad_reduce(const void* partial, void* dw, void* db, const int* p,
                             void* stream) {
  const int P = p[0], C = p[1], Cp = p[2];
  if (P < 1 || C < 1 || Cp < C || Cp % kGroup != 0) return (int)cudaErrorInvalidValue;
  conv4s2_wgrad_reduce_kernel<<<(unsigned)cdiv(kRows * Cp, 32), kReduceWarps * 32, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), static_cast<bf16*>(dw), static_cast<bf16*>(db), P, C, Cp);
  return (int)cudaGetLastError();
}

}  // extern "C"
