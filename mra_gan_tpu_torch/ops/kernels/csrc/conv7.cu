// Stride-1, unpadded 7^3 convolution between a one-channel field and a
// C-channel field, in bf16 with float32 accumulation, for Hopper (sm_90a).
//
// The resnet generator's stem (1 -> ngf) and head (ngf -> 1) are the only
// 7^3 convs of the port. On the TPU they are plain XLA convolutions
// (mra_gan_tpu/ops/conv.py:35, rewritten in mra_gan_tpu/ops/s2d.py because
// one side has a single channel); no Pallas kernel exists for them. cuDNN's
// implicit GEMMs put the single channel (or C = 32) into 256x128 tiles and
// reach 1-7 TFLOP/s on them (its weight gradient ~5). Two kernels serve the
// forward and the input gradient of both convs, two more (with a reduce
// pass) their weight gradients:
//
//   spread (1 -> C):  y[n, v, c] = bias[c] + sum_k a[n, v + k - pad] * W[c, k]
//     stem forward (pad 0) and head input gradient (pad 6, W the head weight
//     flipped; its C is the head's input channels)
//   gather (C -> 1):  y[n, v] = bias + sum_k sum_c x[n, v + k - pad, c] * W[c, k]
//     head forward (pad 0) and stem input gradient (pad 6, W the stem weight
//     flipped)
//   wgrad spread (stem):  dW[c, k] = sum_n sum_v g[n, v, c] * a[n, v + k]
//   wgrad gather (head):  dW[c, k] = sum_n sum_v x[n, v + k, c] * g[n, v]
//
// k runs over the 343 taps (kz, ky, kx), v over the output box, which is the
// input box grown by 2 pad - 6 on each axis; input voxels outside their box
// read as zero (predicated loads: no padded copy is made). Every product is
// summed in float32 by mma.sync.m16n8k16 (bf16 in, f32 accumulate) in one
// fixed order, the bias added in the epilogue, and each output rounded once
// to bf16. No atomics: the result is the same bits on every run.
//
// Layout: the C-channel field is NDHWC (a torch NCDHW tensor in
// channels_last_3d); the one-channel field is (N, D, H, W). Offsets into
// either are int64.
//
// Bound: operations. Per output voxel 2 * 343 * C flops against 2 C + 2
// bytes (spread, written) or 2 C bytes read (gather): ~340 flops a byte at
// C = 32, past the H100's ~295 bf16 flops a byte.
//
// spread_kernel: an implicit GEMM, M = output voxels, N = C (groups of 32
//   channels, four n-tiles of 8), K = the taps laid out as 50 rows (kz, ky)
//   of 8 kx (the 8th kx and the 50th row carry zero weights): 25 k-steps of
//   16. A block owns a 16 x 8 x 4 (x, y, z) output tile; its 22 x 14 x 10
//   input halo sits in shared memory as 32-bit words P[i] = (T[i], T[i+1]),
//   so the two neighbouring kx of an A fragment come in one aligned load
//   whose offset is a compile-time constant of the unrolled k-step. The
//   weights for a group sit in shared memory in fragment order (one 8-byte
//   load per n-tile and k-step). Each warp runs four m-tiles (16 x-voxels
//   each) against the four n-tiles. The output tile is staged in shared
//   memory and written with 16-byte stores.
//
// gather_kernel: per output x-row, Z[u, kx] = sum_{kz, ky, c} x[u + (kz, ky,
//   0) - pad, c] * W[c, kz, ky, kx] is a GEMM with M = the row's input x
//   slots u (5 m-tiles, up to 80 slots: a segment of up to 74 outputs and
//   its 6 halo voxels), N = 8 (kx; the 8th has zero weights) and K = 49 *
//   C; then y[x] = bias + sum_kx Z[x + kx, kx], formed once per output from
//   the accumulators through shared memory. A block owns 4 x 4 (y, z)
//   output rows, one warp each, and walks the 10 input planes (z) its rows
//   reach: each plane's 10 x 80 slots x 32 channels are copied into shared
//   memory with cp.async (zero-filled outside the box and past C), 16-byte
//   chunks XOR-swizzled so that ldmatrix reads them without bank conflicts;
//   the warps whose rows reach that plane run their 7 ky x (C / 16) x 5
//   mma.sync on it. C runs in groups of 32 channels.
//
// wgrad_spread_kernel, wgrad_gather_kernel: one body, D[c, k] = sum_n sum_u
//   F[n, u, c] * S[n, u + k + off] with F the C-channel field, S the
//   one-channel field (zero outside its box) and u over F's box. The stem
//   takes F = g (the 64^3 output box), S = a, off 0, and D is dW. The head
//   takes F = x (the 70^3 input box), S = g, off -6 and D[c, k] = dW[c, 342 -
//   k] (u = v + k, so dW[c, k] = sum_u x[u, c] g[u - k]; the reduce flips the
//   taps). Per (kz, ky) this is a GEMM with M = 32 channels (two m-tiles), N
//   = 8 kx (the 8th is the tile's spare: its column is dropped) and K = the
//   voxels u: A[c][u] = F[u, c] comes from the field tile with ldmatrix.trans
//   (16-byte channel chunks, XOR-swizzled as in the gather), and B[u][kx] =
//   S[u + (kz, ky, kx)] is Hankel along x, so a voxel pair (u, u + 1) and kx
//   read the pair word P[i] = (S[i], S[i + 1]) of the spread's halo trick: the
//   two elements of a B fragment in one aligned load, at a compile-time
//   offset per ky. A tile is 2 z-planes x 4 y-rows x one row segment (at
//   most 72 voxels, of even length, so no pair straddles two rows), voxels
//   flattened x fastest into k-steps of 16 (8 pairs: a table gives each
//   pair's halo word); its S halo (8 x 10 x (segment + 8) words) sits beside
//   it. Seven warps, one per kz, each hold 7 ky x 2 m-tiles of float32
//   accumulators (56 a thread) over every tile of the block; three blocks
//   of 62 KB an SM (-Xptxas -v: 80 registers, a 16-24-byte spill).
//   Bound: the stem's operations (2 * 343 * C flops per output voxel against
//   2 C + 2 bytes read); the head's bytes (its 70^3 x C input read once is
//   the larger). The field tile comes by cp.async with zero-fill (ragged
//   boxes, sharded depth boxes and C < 32 need no padded copy).
//   Split-K without atomics: a fixed grid, min(tiles, resident blocks), each
//   block walking tiles blockIdx.x, + gridDim.x, ... in order, writes its
//   float32 partial (32 x 49 x 8 a channel group) to a workspace;
//   wgrad_reduce_kernel sums the partials in block order, flips the head's
//   taps and rounds each weight once to bf16. Same grid, same order, same
//   bits on every run of a card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 343;
constexpr int kGroup = 32;  // channels per pass over the weights

__device__ __forceinline__ float bf2f(uint16_t b) {
  return __bfloat162float(__ushort_as_bfloat16(b));
}

__device__ __forceinline__ uint16_t f2bf(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

__device__ __forceinline__ uint32_t pack(uint16_t lo, uint16_t hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

__device__ __forceinline__ void mma16816(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// W[c, r * 7 + kx] for tap row r = kz * 7 + ky, zero past the taps or C.
__device__ __forceinline__ uint16_t weight_at(const uint16_t* __restrict__ w, int c, int C,
                                              int r, int kx) {
  return (c < C && r < 49 && kx < 7) ? w[(int64_t)c * kTaps + r * 7 + kx] : (uint16_t)0;
}

// ---------------------------------------------------------------------------
// spread

constexpr int kSX = 16, kSY = 8, kSZ = 4;                   // output tile
constexpr int kHX = kSX + 6, kHY = kSY + 6, kHZ = kSZ + 6;  // input halo
constexpr int kHalo = kHX * kHY * kHZ;                      // 3080 voxels
constexpr int kTile = kSX * kSY * kSZ;                      // 512 voxels
constexpr int kSpreadThreads = 256;                         // 8 warps x 4 m-tiles
constexpr int kKSteps = 25;
constexpr int kStageWords = 20;  // 32 bf16 channels of a voxel + 4 words of padding
constexpr int kSpreadWeightBytes = kKSteps * 4 * 32 * 8;
constexpr int kSpreadHaloBytes = kHalo * 4;
constexpr int kSpreadStageBytes = kTile * kStageWords * 4;
constexpr int kSpreadSmem = kSpreadHaloBytes + kSpreadWeightBytes + kSpreadStageBytes;
static_assert(kSpreadStageBytes >= (kHalo + 8) * 2, "the bf16 halo stages in the output area");

// halo offset of tap row r = kz * 7 + ky (row 49 has zero weights: offset 0)
__host__ __device__ constexpr int spread_row_offset(int r) {
  return r < 49 ? (r / 7) * kHY * kHX + (r % 7) * kHX : 0;
}

__global__ void __launch_bounds__(kSpreadThreads, 2)
conv7_spread_kernel(const uint16_t* __restrict__ a, const uint16_t* __restrict__ w,
                    const uint16_t* __restrict__ bias, uint16_t* __restrict__ y, int Di, int Hi,
                    int Wi, int Do, int Ho, int Wo, int C, int pad, int vec, int tiles_x,
                    int tiles_y) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* P = reinterpret_cast<uint32_t*>(smem);
  uint2* Wf = reinterpret_cast<uint2*>(smem + kSpreadHaloBytes);
  uint32_t* stage = reinterpret_cast<uint32_t*>(smem + kSpreadHaloBytes + kSpreadWeightBytes);
  uint16_t* T = reinterpret_cast<uint16_t*>(stage);

  const int n = blockIdx.y;
  int tile = blockIdx.x;
  const int x0 = (tile % tiles_x) * kSX;
  tile /= tiles_x;
  const int y0 = (tile % tiles_y) * kSY;
  const int z0 = (tile / tiles_y) * kSZ;
  const int tid = threadIdx.x;

  // the halo, zero outside the input box, then its pair words
  const uint16_t* an = a + (int64_t)n * Di * Hi * Wi;
  for (int i = tid; i < kHalo + 8; i += kSpreadThreads) {
    uint16_t v = 0;
    if (i < kHalo) {
      const int hx = i % kHX, hy = (i / kHX) % kHY, hz = i / (kHX * kHY);
      const int gx = x0 + hx - pad, gy = y0 + hy - pad, gz = z0 + hz - pad;
      if (gx >= 0 && gx < Wi && gy >= 0 && gy < Hi && gz >= 0 && gz < Di)
        v = an[((int64_t)gz * Hi + gy) * Wi + gx];
    }
    T[i] = v;
  }
  __syncthreads();
  for (int i = tid; i < kHalo; i += kSpreadThreads) P[i] = pack(T[i], T[i + 1]);
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int tz = warp >> 1, ty0 = (warp & 1) * 4;
  int base[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) base[i] = (tz * kHY + ty0 + i) * kHX + g + 2 * t;

  for (int cb = 0; cb < C; cb += kGroup) {
    // the group's weights in fragment order: B[k][n] = W[cb + 8 j + n, tap k]
    for (int e = tid; e < kKSteps * 4 * 32; e += kSpreadThreads) {
      const int s = e >> 7, j = (e >> 5) & 3, ln = e & 31;
      const int c = cb + 8 * j + (ln >> 2), kx = 2 * (ln & 3);
      Wf[e] = make_uint2(pack(weight_at(w, c, C, 2 * s, kx), weight_at(w, c, C, 2 * s, kx + 1)),
                         pack(weight_at(w, c, C, 2 * s + 1, kx),
                              weight_at(w, c, C, 2 * s + 1, kx + 1)));
    }
    __syncthreads();

    float acc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

#pragma unroll
    for (int s = 0; s < kKSteps; ++s) {
      const int o0 = spread_row_offset(2 * s), o1 = spread_row_offset(2 * s + 1);
      uint2 b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Wf[(s * 4 + j) * 32 + lane];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t a0 = P[base[i] + o0], a1 = P[base[i] + 8 + o0];
        const uint32_t a2 = P[base[i] + o1], a3 = P[base[i] + 8 + o1];
#pragma unroll
        for (int j = 0; j < 4; ++j) mma16816(acc[i][j], a0, a1, a2, a3, b[j].x, b[j].y);
      }
    }

    // epilogue: bias, one rounding, staged per voxel (20 words, conflict-free)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = cb + 8 * j + 2 * t;
      const float b0 = (bias && c < C) ? bf2f(bias[c]) : 0.f;
      const float b1 = (bias && c + 1 < C) ? bf2f(bias[c + 1]) : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int vox = ((tz * kSY) + ty0 + i) * kSX + g;
        stage[vox * kStageWords + 4 * j + t] =
            pack(f2bf(acc[i][j][0] + b0), f2bf(acc[i][j][1] + b1));
        stage[(vox + 8) * kStageWords + 4 * j + t] =
            pack(f2bf(acc[i][j][2] + b0), f2bf(acc[i][j][3] + b1));
      }
    }
    __syncthreads();

    // 16-byte stores of 8 channels (or single ones where C is no multiple of 8)
    for (int e = tid; e < kTile * 4; e += kSpreadThreads) {
      const int vox = e >> 2, q = e & 3;
      const int ox = x0 + vox % kSX, oy = y0 + (vox / kSX) % kSY, oz = z0 + vox / (kSX * kSY);
      const int c = cb + 8 * q;
      if (ox >= Wo || oy >= Ho || oz >= Do || c >= C) continue;
      uint16_t* dst = y + ((((int64_t)n * Do + oz) * Ho + oy) * Wo + ox) * C + c;
      const uint32_t* src = stage + vox * kStageWords + 4 * q;
      if (vec) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        const uint16_t* s16 = reinterpret_cast<const uint16_t*>(src);
        for (int k = 0; k < 8 && c + k < C; ++k) dst[k] = s16[k];
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// gather

constexpr int kGY = 4, kGZ = 4;                // output rows (y, z) of a block, one warp each
constexpr int kGatherThreads = 32 * kGY * kGZ;  // 512
constexpr int kRows = kGY + 6;                 // input rows (y) of a plane
constexpr int kSlots = 80;                     // input x slots of a row: 5 m-tiles
constexpr int kMaxSegment = kSlots - 6;        // outputs of a row segment
constexpr int kPlanes = kGZ + 6;
constexpr int kSlotBytes = kGroup * 2;         // 32 bf16 channels
constexpr int kRowBytes = kSlots * kSlotBytes;
constexpr int kPlaneBytes = kRows * kRowBytes;             // 51,200
constexpr int kGatherWeightBytes = 49 * 2 * 32 * 8;        // 25,088
constexpr int kGatherSmem = kPlaneBytes + kGatherWeightBytes;
constexpr int kZStride = 9;                                // floats a slot in the epilogue
static_assert(kGY * kGZ * kSlots * kZStride * 4 <= kPlaneBytes, "epilogue fits the plane");

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// byte offset of 16-byte chunk q (8 channels) of slot u in a plane row:
// the chunk index is XOR-ed with bits 1-2 of u, so the 8 slots an ldmatrix
// phase reads fall in 8 distinct bank groups
__device__ __forceinline__ int chunk_offset(int u, int q) {
  return u * kSlotBytes + ((q ^ ((u >> 1) & 3)) << 4);
}

__global__ void __launch_bounds__(kGatherThreads, 2)
conv7_gather_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ w,
                    const uint16_t* __restrict__ bias, uint16_t* __restrict__ y, int Di, int Hi,
                    int Wi, int Do, int Ho, int Wo, int C, int pad, int vec, int segment,
                    int segs, int tiles_y) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* plane = smem;
  uint2* Wg = reinterpret_cast<uint2*>(smem + kPlaneBytes);
  const uint32_t plane_s = (uint32_t)__cvta_generic_to_shared(plane);

  const int n = blockIdx.y;
  int tile = blockIdx.x;
  const int x0 = (tile % segs) * segment;
  tile /= segs;
  const int y0 = (tile % tiles_y) * kGY;
  const int z0 = (tile / tiles_y) * kGZ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wz = warp / kGY, wy = warp % kGY;
  const bool live = (z0 + wz < Do) && (y0 + wy < Ho);

  // ldmatrix row addresses: lane l feeds matrix l >> 3, row l & 7; matrices
  // 0-3 are (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7, k 8-15), (rows 8-15, k 8-15)
  const int m = ((lane >> 3) & 1) * 8 + (lane & 7), khalf = lane >> 4;
  const int lane_off0 = chunk_offset(m, khalf), lane_off1 = chunk_offset(m, 2 + khalf);

  float acc[5][4];
#pragma unroll
  for (int i = 0; i < 5; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;

  const uint16_t* xn = x + (int64_t)n * Di * Hi * Wi * C;
  for (int cb = 0; cb < C; cb += kGroup) {
    // the group's weights in fragment order: B[k][n] = W[cb + 16 cs + k, kz, ky, kx = n]
    for (int e = tid; e < 49 * 2 * 32; e += kGatherThreads) {
      const int r = e >> 6, cs = (e >> 5) & 1, ln = e & 31;
      const int kx = ln >> 2, c = cb + 16 * cs + 2 * (ln & 3);
      Wg[e] = make_uint2(pack(weight_at(w, c, C, r, kx), weight_at(w, c + 1, C, r, kx)),
                         pack(weight_at(w, c + 8, C, r, kx), weight_at(w, c + 9, C, r, kx)));
    }
    for (int p = 0; p < kPlanes; ++p) {
      const int gz = z0 + p - pad;
      // the plane: kRows x kSlots slots of 4 chunks, zero outside the box or past C
      for (int e = tid; e < kRows * kSlots * 4; e += kGatherThreads) {
        const int q = e & 3, u = (e >> 2) % kSlots, r = (e >> 2) / kSlots;
        const int gy = y0 + r - pad, gx = x0 + u - pad, c = cb + 8 * q;
        const bool inside = gz >= 0 && gz < Di && gy >= 0 && gy < Hi && gx >= 0 && gx < Wi;
        const int64_t src = inside ? (((int64_t)gz * Hi + gy) * Wi + gx) * C + c : 0;
        const int dst = r * kRowBytes + chunk_offset(u, q);
        if (vec) {
          cp_async16(plane_s + dst, xn + src, inside && c < C);
        } else {
          uint16_t v[8];
#pragma unroll
          for (int k = 0; k < 8; ++k) v[k] = (inside && c + k < C) ? xn[src + k] : (uint16_t)0;
          *reinterpret_cast<uint4*>(plane + dst) =
              make_uint4(pack(v[0], v[1]), pack(v[2], v[3]), pack(v[4], v[5]), pack(v[6], v[7]));
        }
      }
      if (vec) cp_async_wait_all();
      __syncthreads();

      const int kz = p - wz;
      if (live && kz >= 0 && kz < 7) {
        for (int ky = 0; ky < 7; ++ky) {
          const uint32_t row_s = plane_s + (wy + ky) * kRowBytes;
#pragma unroll
          for (int cs = 0; cs < 2; ++cs) {
            const uint2 b = Wg[((kz * 7 + ky) * 2 + cs) * 32 + lane];
            const uint32_t lane_s = row_s + (cs ? lane_off1 : lane_off0);
#pragma unroll
            for (int mt = 0; mt < 5; ++mt) {
              uint32_t a0, a1, a2, a3;
              ldmatrix_x4(lane_s + mt * 16 * kSlotBytes, a0, a1, a2, a3);
              mma16816(acc[mt], a0, a1, a2, a3, b.x, b.y);
            }
          }
        }
      }
      __syncthreads();
    }
  }

  // epilogue: Z[u][kx] through shared memory (9 floats a slot), then
  // y[x] = bias + sum_kx Z[x + kx][kx] in kx order, rounded once
  float* Z = reinterpret_cast<float*>(plane) + warp * kSlots * kZStride;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 5; ++mt) {
    const int u = mt * 16 + g;
    Z[u * kZStride + 2 * t] = acc[mt][0];
    Z[u * kZStride + 2 * t + 1] = acc[mt][1];
    Z[(u + 8) * kZStride + 2 * t] = acc[mt][2];
    Z[(u + 8) * kZStride + 2 * t + 1] = acc[mt][3];
  }
  __syncwarp();
  if (!live) return;
  const float b = bias ? bf2f(bias[0]) : 0.f;
  const int oz = z0 + wz, oy = y0 + wy;
  uint16_t* yrow = y + (((int64_t)n * Do + oz) * Ho + oy) * Wo;
  for (int xl = lane; xl < segment && x0 + xl < Wo; xl += 32) {
    float v = 0.f;
#pragma unroll
    for (int kx = 0; kx < 7; ++kx) v += Z[(xl + kx) * kZStride + kx];
    yrow[x0 + xl] = f2bf(v + b);
  }
}

// ---------------------------------------------------------------------------
// weight gradient: D[c, k] = sum_n sum_u F[n, u, c] * S[n, u + k + kOff]

constexpr int kWTZ = 2, kWTY = 4;                  // a tile: z planes x y rows x a row segment
constexpr int kWMaxSeg = 72;                       // longest row segment (even)
constexpr int kWThreads = 32 * 7;                  // one warp per kz
constexpr int kWVox = kWTZ * kWTY * kWMaxSeg;      // 576 field voxels, 36 k-steps of 16
constexpr int kWHZ = kWTZ + 6, kWHY = kWTY + 6;    // the one-channel halo's planes and rows
constexpr int kWHX = kWMaxSeg + 8;                 // its row stride in pair words
constexpr int kWFieldBytes = kWVox * kSlotBytes;   // 36,864
constexpr int kWHaloBytes = kWHZ * kWHY * kWHX * 4;  // 25,600
constexpr int kWTableBytes = kWVox / 2 * 4;          // 1,152
constexpr int kWSmem = kWFieldBytes + kWHaloBytes + kWTableBytes;
constexpr int kWRows = 49, kWCols = 8;             // a partial: (kz, ky) rows x 8 kx a channel
constexpr int kWPartial = kGroup * kWRows * kWCols;
constexpr int kReduceThreads = 256;
static_assert(kWVox % 16 == 0, "whole k-steps");

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                                  uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// Row segments of a field row of w voxels: the fewest of at most kWMaxSeg,
// balanced, each of an even length so that no voxel pair straddles two.
__host__ __device__ inline int wgrad_segs(int w) { return (w + kWMaxSeg - 1) / kWMaxSeg; }
__host__ __device__ inline int wgrad_seg(int w) {
  const int segs = wgrad_segs(w);
  return ((w + segs - 1) / segs + 1) & ~1;
}

// One block's partial sums over its tiles (tile = blockIdx.x, + gridDim.x, ...)
// for channel group blockIdx.y: partial[block][group][c][kz * 7 + ky][kx].
// F is the C-channel field (N, Fd, Fh, Fw, C), S the one-channel field (N,
// Sd, Sh, Sw), zero outside its box; u runs over F's box.
template <int kOff>
__device__ __forceinline__ void wgrad_body(const uint16_t* __restrict__ field,
                                           const uint16_t* __restrict__ one,
                                           float* __restrict__ partial, int Fd, int Fh, int Fw,
                                           int Sd, int Sh, int Sw, int C, int vec, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* P = reinterpret_cast<uint32_t*>(smem + kWFieldBytes);
  int* table = reinterpret_cast<int*>(smem + kWFieldBytes + kWHaloBytes);
  const uint32_t field_s = (uint32_t)__cvta_generic_to_shared(smem);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int cb = blockIdx.y * kGroup;
  const int segs = wgrad_segs(Fw), seg = wgrad_seg(Fw);
  const int tiles_y = (Fh + kWTY - 1) / kWTY, tiles_z = (Fd + kWTZ - 1) / kWTZ;
  const int vox = kWTZ * kWTY * seg;  // a tile's voxels, x fastest
  const int ksteps = (vox + 15) >> 4;
  const int hx = seg + 8;             // halo words a row that the k-steps read

  // voxel pair p = (2p, 2p + 1): its halo word at tap (0, 0, 0); past the
  // tile, word 0 (its field voxels are zero)
  for (int p = tid; p < kWVox / 2; p += kWThreads) {
    const int v = 2 * p, r = v / seg;
    table[p] = v < vox ? ((r / kWTY) * kWHY + r % kWTY) * kWHX + v % seg : 0;
  }
  // ldmatrix.trans rows: lane l feeds matrix j = l >> 3 with voxel 8 (j >> 1)
  // + (l & 7) of a k-step and the 8 channels of chunk (j & 1) + 2 mt, which
  // gives the A fragment of channels (m) x voxels (k)
  const int lrow = 8 * ((lane >> 3) >> 1) + (lane & 7), lchunk = (lane >> 3) & 1;
  const uint32_t lane_off0 = chunk_offset(lrow, lchunk), lane_off1 = chunk_offset(lrow, 2 + lchunk);
  const int kz_off = warp * kWHY * kWHX;

  float acc[7][2][4];
#pragma unroll
  for (int i = 0; i < 7; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int rest = tile;
    const int x0 = (rest % segs) * seg;
    rest /= segs;
    const int y0 = (rest % tiles_y) * kWTY;
    rest /= tiles_y;
    const int z0 = (rest % tiles_z) * kWTZ;
    const int n = rest / tiles_z;
    __syncthreads();  // the last tile's reads are done

    // the field tile: 16-byte chunks of 8 channels, zero outside the box or past C
    const uint16_t* fn = field + (int64_t)n * Fd * Fh * Fw * C;
    for (int e = tid; e < ksteps * 16 * 4; e += kWThreads) {
      const int q = e & 3, u = e >> 2;
      const int x = u % seg, r = u / seg;
      const int gx = x0 + x, gy = y0 + r % kWTY, gz = z0 + r / kWTY, c = cb + 8 * q;
      const bool inside = u < vox && gx < Fw && gy < Fh && gz < Fd;
      const int64_t src = inside ? (((int64_t)gz * Fh + gy) * Fw + gx) * C + c : 0;
      const int dst = chunk_offset(u, q);
      if (vec) {
        cp_async16(field_s + dst, fn + src, inside && c < C);
      } else {
        uint16_t v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = (inside && c + k < C) ? fn[src + k] : (uint16_t)0;
        *reinterpret_cast<uint4*>(smem + dst) =
            make_uint4(pack(v[0], v[1]), pack(v[2], v[3]), pack(v[4], v[5]), pack(v[6], v[7]));
      }
    }
    // the one-channel halo as pair words P[i] = (S[i], S[i + 1]), zero outside S's box
    const uint16_t* sn = one + (int64_t)n * Sd * Sh * Sw;
    for (int e = tid; e < kWHZ * kWHY * hx; e += kWThreads) {
      const int ix = e % hx, r = e / hx, iy = r % kWHY, iz = r / kWHY;
      const int gx = x0 + ix + kOff, gy = y0 + iy + kOff, gz = z0 + iz + kOff;
      uint16_t lo = 0, hi = 0;
      if (gz >= 0 && gz < Sd && gy >= 0 && gy < Sh) {
        const uint16_t* row = sn + ((int64_t)gz * Sh + gy) * Sw;
        if (gx >= 0 && gx < Sw) lo = row[gx];
        if (gx + 1 >= 0 && gx + 1 < Sw) hi = row[gx + 1];
      }
      P[(iz * kWHY + iy) * kWHX + ix] = pack(lo, hi);
    }
    if (vec) cp_async_wait_all();
    __syncthreads();

    // warp kz: for each k-step of 16 voxels, 7 ky x 2 m-tiles of mma.sync
    for (int s = 0; s < ksteps; ++s) {
      uint32_t a0[4], a1[4];
      ldmatrix_x4_trans(field_s + s * 16 * kSlotBytes + lane_off0, a0[0], a0[1], a0[2], a0[3]);
      ldmatrix_x4_trans(field_s + s * 16 * kSlotBytes + lane_off1, a1[0], a1[1], a1[2], a1[3]);
      const uint32_t* p0 = P + table[8 * s + t] + kz_off + g;
      const uint32_t* p1 = P + table[8 * s + t + 4] + kz_off + g;
#pragma unroll
      for (int ky = 0; ky < 7; ++ky) {
        const uint32_t b0 = p0[ky * kWHX], b1 = p1[ky * kWHX];
        mma16816(acc[ky][0], a0[0], a0[1], a0[2], a0[3], b0, b1);
        mma16816(acc[ky][1], a1[0], a1[1], a1[2], a1[3], b0, b1);
      }
    }
  }

  float* out = partial + ((int64_t)blockIdx.x * gridDim.y + blockIdx.y) * kWPartial;
#pragma unroll
  for (int ky = 0; ky < 7; ++ky)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int c = mt * 16 + g, r = warp * 7 + ky;
      *reinterpret_cast<float2*>(out + (c * kWRows + r) * kWCols + 2 * t) =
          make_float2(acc[ky][mt][0], acc[ky][mt][1]);
      *reinterpret_cast<float2*>(out + ((c + 8) * kWRows + r) * kWCols + 2 * t) =
          make_float2(acc[ky][mt][2], acc[ky][mt][3]);
    }
}

// the stem: F = the output gradient (box Fd), S = the input (box Fd + 6), kOff 0
__global__ void __launch_bounds__(kWThreads, 3)
conv7_wgrad_spread_kernel(const uint16_t* __restrict__ g, const uint16_t* __restrict__ a,
                          float* __restrict__ partial, int Fd, int Fh, int Fw, int C, int vec,
                          int tiles) {
  wgrad_body<0>(g, a, partial, Fd, Fh, Fw, Fd + 6, Fh + 6, Fw + 6, C, vec, tiles);
}

// the head: F = the input (box Fd), S = the output gradient (box Fd - 6),
// kOff -6; D[c, k] is dW[c, 342 - k], flipped by the reduce
__global__ void __launch_bounds__(kWThreads, 3)
conv7_wgrad_gather_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ g,
                          float* __restrict__ partial, int Fd, int Fh, int Fw, int C, int vec,
                          int tiles) {
  wgrad_body<-6>(x, g, partial, Fd, Fh, Fw, Fd - 6, Fh - 6, Fw - 6, C, vec, tiles);
}

// dW[c, k] = sum over the blocks, in block order (four interleaved sums
// joined as (s0 + s1) + (s2 + s3)), of partial[b][c][tap], the tap k or 342 - k
__global__ void __launch_bounds__(kReduceThreads)
conv7_wgrad_reduce_kernel(const float* __restrict__ partial, uint16_t* __restrict__ dw,
                          int blocks, int C, int flip) {
  const int e = blockIdx.x * kReduceThreads + threadIdx.x;
  if (e >= C * kTaps) return;
  const int c = e / kTaps, k = flip ? kTaps - 1 - e % kTaps : e % kTaps;
  const int64_t stride = (int64_t)((C + kGroup - 1) / kGroup) * kWPartial;
  const float* p = partial + (c * kWRows + k / 7) * kWCols + k % 7;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  int b = 0;
  for (; b + 4 <= blocks; b += 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i] += p[(b + i) * stride];
  }
  if (b < blocks) s[0] += p[b * stride];
  if (b + 1 < blocks) s[1] += p[(b + 1) * stride];
  if (b + 2 < blocks) s[2] += p[(b + 2) * stride];
  dw[e] = f2bf((s[0] + s[1]) + (s[2] + s[3]));
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

int wgrad_tiles(int n, int fd, int fh, int fw) {
  return n * ((fd + kWTZ - 1) / kWTZ) * ((fh + kWTY - 1) / kWTY) * wgrad_segs(fw);
}

}  // namespace

extern "C" {

const char* mra_conv7_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// a (N, Di, Hi, Wi) bf16; w (C, 343) bf16; bias (C) bf16 or null;
// y (N, Do, Ho, Wo, C) bf16 with Do = Di + 2 pad - 6 (and H, W so)
int mra_conv7_spread(const void* a, const void* w, const void* bias, void* y, int n, int di,
                     int hi, int wi, int c, int pad, int vec, void* stream) {
  const int d_o = di + 2 * pad - 6, h_o = hi + 2 * pad - 6, w_o = wi + 2 * pad - 6;
  cudaError_t e = allow_smem(conv7_spread_kernel, kSpreadSmem);
  if (e != cudaSuccess) return (int)e;
  const int tiles_x = (w_o + kSX - 1) / kSX, tiles_y = (h_o + kSY - 1) / kSY;
  const int tiles_z = (d_o + kSZ - 1) / kSZ;
  dim3 grid(tiles_x * tiles_y * tiles_z, n);
  conv7_spread_kernel<<<grid, kSpreadThreads, kSpreadSmem, (cudaStream_t)stream>>>(
      (const uint16_t*)a, (const uint16_t*)w, (const uint16_t*)bias, (uint16_t*)y, di, hi, wi,
      d_o, h_o, w_o, c, pad, vec, tiles_x, tiles_y);
  return (int)cudaGetLastError();
}

// x (N, Di, Hi, Wi, C) bf16; w (C, 343) bf16; bias (1) bf16 or null;
// y (N, Do, Ho, Wo) bf16 with Do = Di + 2 pad - 6 (and H, W so)
int mra_conv7_gather(const void* x, const void* w, const void* bias, void* y, int n, int di,
                     int hi, int wi, int c, int pad, int vec, void* stream) {
  const int d_o = di + 2 * pad - 6, h_o = hi + 2 * pad - 6, w_o = wi + 2 * pad - 6;
  cudaError_t e = allow_smem(conv7_gather_kernel, kGatherSmem);
  if (e != cudaSuccess) return (int)e;
  const int segs = (w_o + kMaxSegment - 1) / kMaxSegment;
  const int segment = (w_o + segs - 1) / segs;  // balanced segments of at most 74
  const int tiles_y = (h_o + kGY - 1) / kGY, tiles_z = (d_o + kGZ - 1) / kGZ;
  dim3 grid(segs * tiles_y * tiles_z, n);
  conv7_gather_kernel<<<grid, kGatherThreads, kGatherSmem, (cudaStream_t)stream>>>(
      (const uint16_t*)x, (const uint16_t*)w, (const uint16_t*)bias, (uint16_t*)y, di, hi, wi,
      d_o, h_o, w_o, c, pad, vec, segment, segs, tiles_y);
  return (int)cudaGetLastError();
}

// The weight gradient's first pass runs min(tiles, resident blocks) blocks
// of each channel group: a number fixed by the field's box and the card, so
// that every sum keeps its order from run to run. Returns that number for
// the stem (head 0) or the head (head 1), or minus a CUDA error. The field
// box is (n, fd, fh, fw).
int mra_conv7_wgrad_blocks(int head, int n, int fd, int fh, int fw) {
  const auto kernel = head ? conv7_wgrad_gather_kernel : conv7_wgrad_spread_kernel;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = allow_smem(kernel, kWSmem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWThreads, kWSmem);
  if (e != cudaSuccess) return -(int)e;
  const int tiles = wgrad_tiles(n, fd, fh, fw), resident = sms * (per_sm > 0 ? per_sm : 1);
  return tiles < resident ? tiles : resident;
}

// The first pass: partial sums (blocks, ceil(c / 32) * 32, 49, 8) float32.
// The stem (head 0): field = g (N, fd, fh, fw, c) the output gradient, one =
// a (N, fd + 6, fh + 6, fw + 6) the input. The head (head 1): field = x (N,
// fd, fh, fw, c) the input, one = g (N, fd - 6, fh - 6, fw - 6) the output
// gradient, its taps flipped. All bf16.
int mra_conv7_wgrad(int head, const void* field, const void* one, void* partial, int blocks,
                    int n, int fd, int fh, int fw, int c, int vec, void* stream) {
  const auto kernel = head ? conv7_wgrad_gather_kernel : conv7_wgrad_spread_kernel;
  cudaError_t e = allow_smem(kernel, kWSmem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(blocks, (c + kGroup - 1) / kGroup);
  kernel<<<grid, kWThreads, kWSmem, (cudaStream_t)stream>>>(
      (const uint16_t*)field, (const uint16_t*)one, (float*)partial, fd, fh, fw, c, vec,
      wgrad_tiles(n, fd, fh, fw));
  return (int)cudaGetLastError();
}

// The second pass: dw (c, 343) bf16 from the partials of `blocks` blocks,
// the taps flipped (342 - k) where flip is set.
int mra_conv7_wgrad_reduce(const void* partial, void* dw, int blocks, int c, int flip,
                           void* stream) {
  const int grid = (c * kTaps + kReduceThreads - 1) / kReduceThreads;
  conv7_wgrad_reduce_kernel<<<grid, kReduceThreads, 0, (cudaStream_t)stream>>>(
      (const float*)partial, (uint16_t*)dw, blocks, c, flip);
  return (int)cudaGetLastError();
}

}  // extern "C"
