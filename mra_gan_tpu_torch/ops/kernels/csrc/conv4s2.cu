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
// conv4s2_spread (forward): y[n, c, o] = bias[c] + sum_t w[c, t] x[n, 2o + t - p].
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
// conv4s2_wgrad (weight and bias gradient), first pass:
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
// Bound: memory, at N = 16 and C = 32 the forward reads 8.4 MB and writes
// 33.6 MB (~12.5 us at 3.35 TB/s); its 2.15 GFLOP take ~2 us on the tensor
// cores. A simple kernel: synchronous staging, no TMA and no ring; each
// input voxel is read about (2TD + 2)(2TH + 2)(2TW + 2) / (8 TD TH TW) ~ 2
// times (from L2 beyond the first).
//
// C interface (ctypes, ops/kernels/conv4s2.py): each launcher takes its
// parameters as one int array worked out once a shape on the host, launches
// on the caller's stream and returns a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
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

__device__ __forceinline__ void ldsm_x4_trans(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                              uint32_t& r3, const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(a)
               : "memory");
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

}  // namespace

extern "C" {

const char* mra_conv4s2_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// x (N, 1, D, H, W), w (C, 64), bias (C) or null -> y (N, Do, Ho, Wo, C).
int mra_conv4s2_spread(const void* x, const void* w, const void* bias, void* y, const int* p,
                       void* stream) {
  Geo g;
  if (!make_geo(&g, p, false)) return (int)cudaErrorInvalidValue;
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
// float32; p[12] the grid (at most the tiles).
int mra_conv4s2_wgrad(const void* x, const void* gr, void* partial, const int* p, void* stream) {
  Geo g;
  if (!make_geo(&g, p, false)) return (int)cudaErrorInvalidValue;
  const int grid = p[12];
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
