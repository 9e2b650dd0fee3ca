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
// read as zero (zero-filled copies: no padded copy is made). Every product is
// summed in float32 on the tensor cores (bf16 in, f32 accumulate) in one
// fixed order, the bias added in the epilogue, and each output rounded once
// to bf16. No atomics: the result is the same bits on every run.
//
// Layout: the C-channel field is NDHWC (a torch NCDHW tensor in
// channels_last_3d); the one-channel field is (N, D, H, W). Offsets into
// either are int64. C runs in groups of 32 channels; any C is taken (C > 64
// in chunks, below).
//
// Bound: operations. Per output voxel 2 * 343 * C flops against 2 C + 2
// bytes (spread, written) or 2 C bytes read (gather): ~340 flops a byte at
// C = 32, past the H100's ~295 bf16 flops a byte. The head's input gradient
// (a spread writing 70^3 x 32 channels) and the head forward (a gather
// reading 70^3 x 32) are bounded by their bytes instead.
//
// Both kernels are persistent (one grid of at most the resident blocks, each
// walking tiles blockIdx.x, + gridDim.x, ... in a fixed order) and warp
// specialised: one producer warp streams the input into a ring of shared
// memory under mbarriers (full: the copy landed; empty: the consumers are
// done with it) while consumer warpgroups multiply with wgmma. Operands in
// shared memory are K-major rows of 64 bytes under the 64-byte swizzle
// (chunk_offset), the layout TMA writes with CU_TENSOR_MAP_SWIZZLE_64B and
// wgmma reads with layout type 2; a k-step of 16 channels or taps is the
// first or second half of such a row (descriptor start + 32 bytes).
// setmaxnreg is not used: the producer is one warp, and an increase past
// what ptxas allocated at launch would block for ever.
//
// spread_kernel: an implicit GEMM, M = output voxels, N = C (a group of 32
//   channels), K = the taps laid out as k = 64 kz + 8 ky + kx (ky 7 and kx 7
//   carry zero weights): 28 k-steps of 16, each one kz and a pair of ky.
//   One consumer warpgroup owns a 16 x 4 x 4 (x, y, z) output tile: four
//   m64 tiles, one per z plane, a warp per y row. wgmma m64n32k16 takes A
//   from registers: the 22 x 10 x 10 input halo sits in shared memory as
//   32-bit pair words P[i] = (T[i], T[i+1]), so the two neighbouring kx of
//   an A fragment come in one aligned load whose offset is a compile-time
//   constant (the register fragment of wgmma is mma.sync's). Halo plane zz
//   is what m-tile i reads at kz = zz - i, so the loop runs over the ten
//   halo planes and the ky pairs: each A fragment is loaded once and fed to
//   every m-tile that reads it (160 loads a thread a tile where a k-step
//   loop over the m-tiles takes 400; 112 wgmma a channel group). That is
//   why K keeps zero slots (448 for 343 taps, against 400 for 50 rows of 8
//   kx before): a k-step must lie in one kz plane, which the 344-tap layout
//   breaks, so it was not built. The A registers are double-buffered so step s + 1's
//   loads overlap step s's multiplies. B, the weights of every group where
//   C <= 64, is loaded once per block (16-byte loads) into shared memory in
//   wgmma's layout; a tile runs the groups in turn. Where C > 64 a tile
//   holds one group, the group is the slowest index of the tile number, so
//   a block's walk enters each group once and reloads the weights there
//   (conv7_spread_kernel<true>; C <= 64 compiles without the reload).
//   The producer warp copies the next tile's raw halo (cp.async in 4-byte
//   granules where W is even, plain loads otherwise) into a second buffer
//   while this tile multiplies. The output tile is staged in shared memory
//   (swizzled, conflict-free) and written by one TMA store (box (32, 16, 4,
//   4, 1) over NDHWC; TMA cuts the ragged edge), which overlaps the next
//   tile's work; where C is no multiple of 8 the threads store it. Three
//   blocks an SM (62 KB each) where one group's weights are held, two (90
//   KB) where two are (C 33-64).
//
// gather_kernel: C -> 1 has one output channel, so the taps themselves fill
//   the tile's rows. Per input row (plane zi, row yi) and output plane zo =
//   zi - kz + pad the GEMM is D[m, u] = sum_c W[c, kz, ky, kx] * x[zi, yi,
//   u, c], summed over the 7 kz and the channel groups on the tensor cores
//   (14 k-steps of m64n80k16 at C = 32), with M = (ky, kx) as m = 8 ky + kx
//   (49 of 64 rows carry weights) and N = 80 input x slots (a row segment of
//   at most 74 outputs and its 6-voxel halo). A, the weights, sit in shared
//   memory for the whole kernel where C <= 64; B is the input row as TMA
//   delivers it
//   (box (32, 80, 1, 1) over (C, W, H, D * N), zero-filled outside the box;
//   a plane outside the box is zeros that the producer writes, since the
//   depth coordinate n * D + z would read the next sample). The epilogue
//   forms Z[ky, x] = sum_kx D[8 ky + kx, x + kx] through shared memory in kx
//   order and adds it to the output row yi + pad - ky of plane zo held in Y,
//   seven output rows deep: after input row yi the output row yi + pad - 6
//   is complete, is written (bias added, rounded once) and its row of Y is
//   zeroed for reuse. Each Y element gets one addition per input row, in
//   row order. A tile is (n, Zt output planes, Rt output rows, one x
//   segment); its input rows run in order, and for each row the producer
//   streams its Zt + 6 planes through a ring of up to 16 stages: item (zo,
//   yi) needs the seven planes zo..zo+6 of the row, so consecutive items
//   share six. Four consumer warpgroups (two where C is 33-64, for room) take
//   output planes j = q, q + 4, ...; a plane of Y is only ever added to by
//   its own warpgroup, which also writes and zeroes its rows, so the
//   warpgroups run apart and one's epilogue overlaps another's multiplies.
//   They meet only in the ring: a stage goes back to the producer once
//   every consumer warp has handed it back (one arrival a warp), each only
//   after the plane landed (an early arrival would count toward the stage's
//   previous use).
//   C > 64 (conv7_gather_kernel<1, true>): the weights of every group do not
//   fit beside the ring, so each input row runs through the groups one at a
//   time (the producer streams the row's planes once a group), and the
//   consumers reload a group's weights (28 KB, a barrier of all of them)
//   where a row enters another group; rows alternate the groups' order, so
//   each row reloads one group fewer. Y takes one addition per row and
//   group, in (row, group) order: the same order for every tiling.
//   What the old kernel lost was the share of an input row that each output
//   row re-used. Here an input row is read from L2 once per tile and serves
//   every output row it reaches (all seven ky sit in M: the design's R is
//   those seven rows, with no zero-padded output rows) and all Zt planes.
//   The re-read factor is (Zt + 6) / Zt over the planes times the rows each
//   tile reads over the box's: 1.49 for the 64^3 head forward at N = 16
//   (tiles of 16 planes x 32 rows) and 1.90 at N = 8 (8 x 32), against 6.8
//   before. (On the H100 the loads set the pace: with the multiplies and
//   the epilogue compiled out the head forward still takes half its time.)
//   No consumer warp waits out a plane it does not use (30% of the
//   warp-planes before); the tensor cores multiply 15 zero rows of 64
//   and the spare slots, so 49/64 x 70/80 = 67% of the issued work at a
//   64-wide row is the conv's. The tiling (Zt 16, 8 or 4, a multiple of the
//   warpgroups; Rt the rows or a half, third or quarter of them) is chosen
//   on the host (conv7.py gather_plan) by a cost model of loads and
//   multiplies over the busiest tile and the waves; conv7_sweep.py times
//   every tiling against its pick.
//   A later clamped read of the pad-0 roles' input (to fold the replication
//   pad in front of the stem and head) cannot use TMA's zero fill: it would
//   clamp the TMA coordinates of each row instead (a row at yi < 0 read as
//   row 0, a plane likewise) and clamp the x halo by a second box for the
//   edge slots, all in the producer (spread: the halo loader), which is the
//   only place either kernel reads its input.
//
// Registers (-Xptxas -v, sm_90a, CUDA 12.8; build/kernels/conv7-*.so.log):
//   spread 128, gather 73 (one channel group) and 85 (two), no spills; where
//   C > 64 (the reload in the walk) the spread 128 with a 116-byte spill and
//   the gather 84.
//
// wgrad_spread_kernel, wgrad_gather_kernel: one body, D[c, k] = sum_n sum_u
//   F[n, u, c] * S[n, u + k + off] with F the C-channel field, S the
//   one-channel field (zero outside its box) and u over F's box. The stem
//   takes F = g (the 64^3 output box), S = a, off 0, and D is dW. The head
//   takes F = x (the 70^3 input box), S = g, off -6 and D[c, k] = dW[c, 342 -
//   k] (u = v + k, so dW[c, k] = sum_u x[u, c] g[u - k]; the reduce flips the
//   taps). Bound: both near the ridge, the stem by its operations (2 * 343 *
//   C flops per voxel of F against 2 C + 2 bytes read), the head by its
//   bytes (its 70^3 x C input read once); the tensor cores also multiply 15
//   dead rows of 64, so 49/64 of the issued work is the conv's.
//   Per kz the GEMM is D^T[m, c] = sum_u A[m][u] B[u][c] with the taps in M
//   (m = 8 ky + kx: 49 of an m64 tile's rows live, ky 7 and kx 7 dropped at
//   the store), the 32 channels of a group in N and the voxels in K:
//   wgmma m64n32k16, seven accumulator tiles (one per kz, 112 floats a
//   thread). B[u][c] = F[u, c] is the field tile as TMA lays it out (64-byte
//   rows of 32 channels, the 64-byte swizzle), which for wgmma is an
//   MN-major operand (desc_mn_sw64, the transpose bit set). A[m][u] = S[u +
//   (kz, ky, kx) + off] comes from registers: it is Hankel along x, so the
//   two neighbouring voxels of an A fragment are one pair word P[i] = (T[i],
//   T[i + 1]) of the halo, the spread's trick; warp w of a warpgroup owns ky
//   2w and 2w + 1 (ky 7 reads row 6). A tile is kWTZ = 8 planes x kWTY = 2
//   rows x a row segment of xt <= 72 voxels (even, so no pair straddles two
//   rows; conv7.py wgrad_plan), each plane's 2 xt voxels flattened x fastest
//   into k-steps of 16 (a table gives each voxel pair's halo word; the
//   slots past them stay zero). Voxels on tile plane pz read halo plane h =
//   pz + kz, so the loop runs over the 14 halo planes of a k-step: each A
//   fragment (four 32-bit loads) is loaded once and fed to every kz that
//   reads it, 14 loads for 56 wgmma, double-buffered in registers so step
//   h + 1's loads overlap step h's multiplies; the loops have no runtime
//   branch around a wgmma (the halo planes and kz are unrolled).
//   Warp specialised and pipelined: a producer warpgroup fills a ring of two
//   stages (the field tile, 72 KB, by one TMA a plane over NDHWC with zero
//   fill, or by its threads where C % 8 != 0; the halo's pair words, 35 KB)
//   under mbarriers, while two consumer warpgroups multiply the other stage,
//   warpgroup q taking k-steps q, q + 2, ... of each plane (the odd one
//   alternates between tiles). Each producer warp makes two of the halo's
//   eight rows: a lane loads its words (T[2j], T[2j + 1]) of all 14 planes
//   into registers at once (32-bit loads where the one-channel field's
//   width is even, else two 16-bit ones), takes word j + 1 from the next
//   lane by a shuffle and stores the pair words 2j and 2j + 1 with one
//   64-bit store. (Built first with one producer warp that staged the halo
//   by cp.async and converted it in shared memory, then with four, the
//   producer set the pace on an H100, several times and then ~1.5 times
//   what the consumers alone take; registers and shuffles bring the first
//   pass near the consumers' own time.) One block an SM (215 KB of shared
//   memory).
//   Split-K without atomics: a fixed grid, min(tiles, resident blocks / the
//   channel groups) blocks a group, each walking tiles blockIdx.x, +
//   gridDim.x, ... in order; each consumer warpgroup writes its float32
//   partial (32 x 49 x 8 a channel group) to a workspace, and
//   wgrad_reduce_kernel sums the partials in order, flips the head's taps
//   and rounds each weight once to bf16. Same grid, same order, same bits on
//   every run of a card.
//   Registers (-Xptxas -v, sm_90a): 168 for both, no spills (the bound for
//   384 threads; setmaxnreg is not used).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kTaps = 343;
constexpr int kGroup = 32;              // channels per pass over the weights
constexpr int kSlotBytes = kGroup * 2;  // 32 bf16 channels: one 64-byte row
constexpr int kMaxGroups = 2;  // the spread's weights held at once: C > 64 a group at a time
constexpr int kMaxSmem = 232448;        // a block's shared memory on sm_90

__device__ __forceinline__ float bf2f(uint16_t b) {
  return __bfloat162float(__ushort_as_bfloat16(b));
}

__device__ __forceinline__ uint16_t f2bf(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

__device__ __forceinline__ uint32_t pack(uint16_t lo, uint16_t hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

// byte offset of 16-byte chunk q (8 channels) of row u in a tile of 64-byte
// rows: the chunk index is XOR-ed with bits 1-2 of u (the 64-byte swizzle of
// TMA and wgmma, taken on address bits, so a tile starts on 512 bytes), and
// the 8 rows an ldmatrix phase or a warp's stores touch fall in 8 distinct
// bank groups
__device__ __forceinline__ int chunk_offset(int u, int q) {
  return u * kSlotBytes + ((q ^ ((u >> 1) & 3)) << 4);
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 4 : 0));
}

// ---------------------------------------------------------------------------
// Hopper's asynchronous pieces: mbarriers, TMA, wgmma

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

// one arrival once every cp.async this thread issued has landed
__device__ __forceinline__ void mbar_arrive_cp_async(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
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

// threads' writes to shared memory made visible to TMA and wgmma
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

__device__ __forceinline__ void tma_store_5d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5, %6}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(c4)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the last TMA store has read its tile out of shared memory
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// a wgmma operand descriptor: K-major rows of 64 bytes under the 64-byte
// swizzle, 8-row groups 512 bytes apart (the leading offset is unused)
__device__ __forceinline__ uint64_t desc_sw64(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(512 >> 4) << 32) |
         ((uint64_t)2 << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps a register (an accumulator, an A fragment) where it is until here:
// wgmma reads and writes them asynchronously, so nothing may move or reuse
// them between the instruction and its wait
__device__ __forceinline__ void pin(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void pin(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

// D (64 x 80, f32) += A (64 x 16, shared) * B (16 x 80, shared), both K-major
__device__ __forceinline__ void wgmma_m64n80k16_ss(float (&d)[40], uint64_t da, uint64_t db) {
  const uint32_t one = 1;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39}, %40, %41, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(da), "l"(db), "r"(one));
}

// D (64 x 32, f32) += A (64 x 16, registers) * B (16 x 32, shared): B
// K-major, or MN-major where kTransB is 1
template <int kTransB = 0>
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16], const uint32_t (&a)[4],
                                                   uint64_t db) {
  const uint32_t one = 1;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(one), "n"(kTransB));
}

// Every weight W[c, tap] of channels [c0, c1) of the (C, 343) tensor read
// once (16-byte loads where aligned) and stored at byte place(c - c0, tap)
// of dst, which the caller zeroed; threads tid, + nthreads, ...
template <typename Place>
__device__ __forceinline__ void scatter_weights(const uint16_t* __restrict__ w, int c0, int c1,
                                                unsigned char* dst, int tid, int nthreads,
                                                Place place) {
  w += (int64_t)c0 * kTaps;  // 32 channels are 21,952 bytes: a group starts aligned
  const int total = (c1 - c0) * kTaps;
  const bool aligned = (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  for (int f0 = 8 * tid; f0 < total; f0 += 8 * nthreads) {
    union {
      uint4 q;
      uint16_t h[8];
    } v;
    if (aligned && f0 + 8 <= total) {
      v.q = *reinterpret_cast<const uint4*>(w + f0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v.h[e] = f0 + e < total ? w[f0 + e] : (uint16_t)0;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int f = f0 + e;
      if (f < total) *reinterpret_cast<uint16_t*>(dst + place(f / kTaps, f % kTaps)) = v.h[e];
    }
  }
}

__device__ __forceinline__ void zero_bytes(unsigned char* dst, int bytes, int tid, int nthreads) {
  for (int i = 16 * tid; i < bytes; i += 16 * nthreads)
    *reinterpret_cast<uint4*>(dst + i) = make_uint4(0, 0, 0, 0);
}

// ---------------------------------------------------------------------------
// spread

constexpr int kSX = 16, kSY = 4, kSZ = 4;                   // output tile (x, y, z)
constexpr int kHX = kSX + 6, kHY = kSY + 6, kHZ = kSZ + 6;  // input halo
constexpr int kHalo = kHX * kHY * kHZ;                      // 2200 voxels
constexpr int kSTile = kSX * kSY * kSZ;                     // 256 voxels: four m64 tiles
constexpr int kSKBlocks = 14;  // K = 64 kz + 8 ky + kx: 448 tap slots, 64-byte rows of 32
constexpr int kSWeightBytes = kSKBlocks * kGroup * kSlotBytes;  // 28,672 a group
constexpr int kSOutBytes = kSTile * kSlotBytes;                 // 16,384
constexpr int kSPairBytes = kHalo * 4;                          // 8,800
constexpr int kSHaloBytes = (kHalo * 2 + 15) / 16 * 16;         // 4,400 a stage
constexpr int kSpreadThreads = 160;  // a consumer warpgroup and a producer warp

// halo offset of row ky of halo plane zz (row 7 has zero weights: row 6's)
__host__ __device__ constexpr int spread_row_offset(int zz, int ky) {
  return zz * kHY * kHX + (ky < 7 ? ky : 6) * kHX;
}

__host__ __device__ constexpr int spread_smem(int groups) {
  return 1024 + groups * kSWeightBytes + kSOutBytes + kSPairBytes + 2 * kSHaloBytes + 4 * 8;
}

// tile t -> (n, z0, y0, x0), x fastest
__device__ __forceinline__ void tile_origin(int t, int tz, int ty, int tx, int nz, int ny, int nx,
                                            int& n, int& z0, int& y0, int& x0) {
  x0 = (t % nx) * tx;
  t /= nx;
  y0 = (t % ny) * ty;
  t /= ny;
  z0 = (t % nz) * tz;
  n = t / nz;
}

// the consumers load channels [c0, c1) (at most two groups) of the weights:
// B[g][k / 32][n][k % 32] = W[c0 + 32 g + n, tap(k)], k = 64 kz + 8 ky + kx.
// Inlined where it runs once before the walk; a call where it runs inside
// it (C > 64), which keeps it out of the walk's registers
__device__ __forceinline__ void spread_weights(const uint16_t* __restrict__ w, int c0, int c1,
                                               unsigned char* wB, int tid) {
  bar_sync(1, 128);  // every wgmma on the last chunk's weights is done
  zero_bytes(wB, (c1 - c0 + kGroup - 1) / kGroup * kSWeightBytes, tid, 128);
  bar_sync(1, 128);
  scatter_weights(w, c0, c1, wB, tid, 128, [](int c, int tap) {
    const int k = 64 * (tap / 49) + 8 * ((tap / 7) % 7) + tap % 7, n = c % kGroup;
    return (c / kGroup) * kSWeightBytes + (k >> 5) * (kGroup * kSlotBytes) +
           chunk_offset(n, (k & 31) >> 3) + (k & 7) * 2;
  });
  fence_proxy_async();
  bar_sync(1, 128);
}

__device__ __noinline__ void spread_weights_call(const uint16_t* __restrict__ w, int c0, int c1,
                                                 unsigned char* wB, int tid) {
  spread_weights(w, c0, c1, wB, tid);
}

// kChunked: C > 64, tiles of each channel group (the slowest index of t),
// the group's weights loaded where a block's walk enters it; else one chunk
// of every group, its weights loaded once
template <bool kChunked>
__global__ void __launch_bounds__(kSpreadThreads, 3)
conv7_spread_kernel(const __grid_constant__ CUtensorMap out_map, const uint16_t* __restrict__ a,
                    const uint16_t* __restrict__ w, const uint16_t* __restrict__ bias,
                    uint16_t* __restrict__ y, int Di, int Hi, int Wi, int Do, int Ho, int Wo,
                    int C, int pad, int vec, int granules, int nz, int ny, int nx, int tiles) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int groups = kChunked ? 1 : (C + kGroup - 1) / kGroup;  // a chunk's
  const int per_chunk = kChunked ? tiles / ((C + kGroup - 1) / kGroup) : tiles;  // its tiles
  unsigned char* wB = smem;                                    // groups x [14][32 n][64 B]
  unsigned char* out = wB + groups * kSWeightBytes;            // [256 voxels][64 B]
  uint32_t* P = reinterpret_cast<uint32_t*>(out + kSOutBytes);  // pair words
  unsigned char* halo = out + kSOutBytes + kSPairBytes;        // 2 stages of raw bf16
  uint64_t* bars = reinterpret_cast<uint64_t*>(halo + 2 * kSHaloBytes);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + 2);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(full0 + 8 * s, 32);    // one arrival per producer lane
      mbar_init(empty0 + 8 * s, 128);  // one per consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    // producer: each tile's raw halo T[hz][hy][hx], zero outside the input box
    const int64_t plane = (int64_t)Hi * Wi;
    int k = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++k) {
      int n, z0, y0, x0;
      tile_origin(kChunked ? t % per_chunk : t, kSZ, kSY, kSX, nz, ny, nx, n, z0, y0, x0);
      const int s = k & 1;
      mbar_wait(empty0 + 8 * s, ((k >> 1) & 1) ^ 1);
      const uint16_t* an = a + (int64_t)n * Di * plane;
      uint16_t* T = reinterpret_cast<uint16_t*>(halo + s * kSHaloBytes);
      if (granules) {
        // W even and x0 - pad even: a pair (gx, gx + 1) is inside or outside together
        const uint32_t T_s = smem_u32(T);
        for (int e = lane; e < kHZ * kHY * (kHX / 2); e += 32) {
          const int hx = 2 * (e % (kHX / 2)), r = e / (kHX / 2), hy = r % kHY, hz = r / kHY;
          const int gx = x0 + hx - pad, gy = y0 + hy - pad, gz = z0 + hz - pad;
          const bool inside = gz >= 0 && gz < Di && gy >= 0 && gy < Hi && gx >= 0 && gx < Wi;
          const uint16_t* src = inside ? an + gz * plane + (int64_t)gy * Wi + gx : an;
          cp_async4(T_s + 2 * ((hz * kHY + hy) * kHX + hx), src, inside);
        }
        mbar_arrive_cp_async(full0 + 8 * s);
      } else {
        for (int i = lane; i < kHalo; i += 32) {
          const int hx = i % kHX, hy = (i / kHX) % kHY, hz = i / (kHX * kHY);
          const int gx = x0 + hx - pad, gy = y0 + hy - pad, gz = z0 + hz - pad;
          const bool inside = gz >= 0 && gz < Di && gy >= 0 && gy < Hi && gx >= 0 && gx < Wi;
          T[i] = inside ? an[gz * plane + (int64_t)gy * Wi + gx] : (uint16_t)0;
        }
        mbar_arrive(full0 + 8 * s);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  if (!kChunked) spread_weights(w, 0, C, wB, tid);

  const int g = lane >> 2, t4 = lane & 3;
  const int base = warp * kHX + g + 2 * t4;  // halo word of (x = g + 2 t4, y = warp) in plane 0
  const uint32_t wB_s = smem_u32(wB), out_s = smem_u32(out);

  int k = 0, loaded = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++k) {
    int n, z0, y0, x0;
    tile_origin(kChunked ? t % per_chunk : t, kSZ, kSY, kSX, nz, ny, nx, n, z0, y0, x0);
    const int c0 = kChunked ? t / per_chunk * groups * kGroup : 0;  // the chunk's first channel
    if (kChunked && (k == 0 || c0 != loaded)) {
      spread_weights_call(w, c0, min(C, c0 + kGroup), wB, tid);
      loaded = c0;
    }
    const int s = k & 1;
    mbar_wait(full0 + 8 * s, (k >> 1) & 1);
    const uint16_t* T = reinterpret_cast<const uint16_t*>(halo + s * kSHaloBytes);
    for (int i = tid; i < kHalo; i += 128) P[i] = pack(T[i], i + 1 < kHalo ? T[i + 1] : 0);
    mbar_arrive(empty0 + 8 * s);
    bar_sync(1, 128);

    const int c_end = kChunked ? c0 + 1 : C;  // one group a tile where chunked
    for (int cb = c0; cb < c_end; cb += kGroup) {
      const uint32_t wg_s = wB_s + ((cb - c0) / kGroup) * kSWeightBytes;
      float acc[4][16];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 16; ++q) acc[i][q] = 0.f;
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 16; ++q) pin(acc[i][q]);
      // halo plane zz feeds output plane i (m-tile i) at kz = zz - i: its A
      // fragment for a ky pair is loaded once for every m-tile that reads it
#pragma unroll
      for (int st = 0; st < (kSZ + 6) * 4; ++st) {
        const int zz = st >> 2, pr = st & 3;
        const int o0 = spread_row_offset(zz, 2 * pr), o1 = spread_row_offset(zz, 2 * pr + 1);
        uint32_t(&a_)[4] = af[st & 1];
        a_[0] = P[base + o0];
        a_[1] = P[base + 8 + o0];
        a_[2] = P[base + o1];
        a_[3] = P[base + 8 + o1];
        wg_fence();
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kz = zz - i;
          if (kz < 0 || kz > 6) continue;
          const int ks = kz * 4 + pr;  // the k-step: K slots 16 ks ...
          wgmma_m64n32k16_rs(acc[i], a_,
                             desc_sw64(wg_s + (ks >> 1) * (kGroup * kSlotBytes) + (ks & 1) * 32));
        }
        wg_commit();
        wg_wait<1>();  // step st - 1 is done: its A registers may be reused
        if (st > 0) {
#pragma unroll
          for (int q = 0; q < 4; ++q) pin(af[(st - 1) & 1][q]);
        }
      }
      wg_wait<0>();
#pragma unroll
      for (int q = 0; q < 4; ++q) pin(af[((kSZ + 6) * 4 - 1) & 1][q]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 16; ++q) pin(acc[i][q]);

      // epilogue: bias, one rounding, the tile staged as TMA's box lays it out
      if (tid == 0) tma_store_wait_read();
      bar_sync(1, 128);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = cb + 8 * j + 2 * t4;
        const float b0 = (bias && c < C) ? bf2f(bias[c]) : 0.f;
        const float b1 = (bias && c + 1 < C) ? bf2f(bias[c + 1]) : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int v = (i * kSY + warp) * kSX + g + 8 * h;
            *reinterpret_cast<uint32_t*>(out + chunk_offset(v, j) + 4 * t4) =
                pack(f2bf(acc[i][4 * j + 2 * h] + b0), f2bf(acc[i][4 * j + 2 * h + 1] + b1));
          }
        }
      }
      fence_proxy_async();
      bar_sync(1, 128);
      if (vec) {
        if (tid == 0) tma_store_5d(&out_map, out_s, cb, x0, y0, z0, n);
      } else {
        for (int e = tid; e < kSTile * 4; e += 128) {
          const int v = e >> 2, q = e & 3, c = cb + 8 * q;
          const int ox = x0 + v % kSX, oy = y0 + (v / kSX) % kSY, oz = z0 + v / (kSX * kSY);
          if (ox >= Wo || oy >= Ho || oz >= Do || c >= C) continue;
          uint16_t* dst = y + ((((int64_t)n * Do + oz) * Ho + oy) * Wo + ox) * C + c;
          const uint16_t* src = reinterpret_cast<const uint16_t*>(out + chunk_offset(v, q));
          for (int e2 = 0; e2 < 8 && c + e2 < C; ++e2) dst[e2] = src[e2];
        }
      }
    }
  }
  if (tid == 0) tma_store_wait();
}

// ---------------------------------------------------------------------------
// gather

constexpr int kGSlots = 80;                          // input x slots of a row: wgmma N
constexpr int kGMaxSegment = kGSlots - 6;            // outputs of a row segment
constexpr int kGMaxDepth = 16;                       // output planes of a tile
constexpr int kGRowBytes = kGSlots * kSlotBytes;     // 5,120: a row of one channel group
constexpr int kGWeightBytes = 7 * 64 * kSlotBytes;   // 28,672 a group: [kz][8 ky + kx][32 c]
constexpr int kZRow = 88;                            // floats a row of Z (conflict-free)
constexpr int kGZBytes = 49 * kZRow * 4;             // 17,248 a consumer warpgroup
constexpr int kGYBytes = 7 * kGMaxDepth * kGSlots * 4;  // 35,840: 7 output rows x Zt planes
constexpr int kGMaxStages = 16;

// A stage and the weights in shared memory hold a chunk of `groups` channel
// groups: two where C is 33-64, else one (C <= 32, or C > 64 taken a group at
// a time). Consumer warpgroups: four for one group, two for two (their
// planes in flight and the ring's stages must fit beside the weights)
__host__ __device__ constexpr int gather_warpgroups(int groups) { return groups == 1 ? 4 : 2; }

__host__ __device__ constexpr int gather_chunk_groups(int C) {
  return (C + kGroup - 1) / kGroup == 2 ? 2 : 1;
}

// the chunk of channels taken i-th on input row yi: rows alternate the
// order, so a row starts on the chunk whose weights the last one left in
// place (and every tiling sums in the same order)
__device__ __forceinline__ int gather_chunk(int yi, int i, int chunks) {
  return (yi & 1) ? chunks - 1 - i : i;
}

__host__ __device__ constexpr int gather_threads(int groups) {
  return 128 * gather_warpgroups(groups) + 32;  // and a producer warp
}

__host__ __device__ constexpr int gather_fixed_smem(int groups) {
  return 1024 + groups * kGWeightBytes + gather_warpgroups(groups) * kGZBytes + kGYBytes;
}

// ring stages that fit beside the rest (at least 8: an item reads 7 planes)
__host__ __device__ constexpr int gather_stages(int groups) {
  return (kMaxSmem - gather_fixed_smem(groups)) / (groups * kGRowBytes + 16) < kGMaxStages
             ? (kMaxSmem - gather_fixed_smem(groups)) / (groups * kGRowBytes + 16)
             : kGMaxStages;
}

__host__ __device__ constexpr int gather_smem(int groups) {
  return gather_fixed_smem(groups) + gather_stages(groups) * (groups * kGRowBytes + 16);
}
static_assert(gather_stages(1) >= 8 && gather_stages(2) >= 8, "a ring an item fits in");

// hands the row's planes [released, upto) back to the producer, each after
// it has landed: an arrival on a stage not yet refilled would count toward
// its previous use
__device__ __forceinline__ void gather_release(uint32_t full0, uint32_t empty0, uint32_t L, int S,
                                               int& released, int& waited, int upto) {
  for (; released < upto; ++released) {
    for (; waited <= released; ++waited)
      mbar_wait(full0 + 8 * ((L + waited) % S), ((L + waited) / S) & 1);
    __syncwarp();  // one arrival a warp, once all its lanes are done
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty0 + 8 * ((L + released) % S));
  }
}

// item j (output plane j of the tile) of the row whose first plane is load
// L: waits for its planes j .. j + 6, then issues acc = the sum over kz and
// the channel groups of the weights times plane j + kz (one commit group)
template <int kG, int kS>
__device__ __forceinline__ void gather_issue(float (&acc)[40], uint32_t ring_s, uint32_t wA_s,
                                             uint32_t full0, uint32_t L, int j, int& waited) {
  constexpr int stage_bytes = kG * kGRowBytes;
  for (; waited < j + 7; ++waited)
    mbar_wait(full0 + 8 * ((L + waited) % kS), ((L + waited) / kS) & 1);
#pragma unroll
  for (int i = 0; i < 40; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 40; ++i) pin(acc[i]);
  wg_fence();
#pragma unroll
  for (int kz = 0; kz < 7; ++kz) {
    const uint32_t row_s = ring_s + ((L + j + kz) % kS) * stage_bytes;
#pragma unroll
    for (int gr = 0; gr < kG; ++gr) {
      const uint32_t a_s = wA_s + (gr * 7 + kz) * (64 * kSlotBytes);
      const uint32_t b_s = row_s + gr * kGRowBytes;
      wgmma_m64n80k16_ss(acc, desc_sw64(a_s), desc_sw64(b_s));
      wgmma_m64n80k16_ss(acc, desc_sw64(a_s + 32), desc_sw64(b_s + 32));
    }
  }
  wg_commit();
}

// item j's accumulators are complete (waited for): its planes before
// `upto` go back to the producer; Z[ky * 7 + kx][u] = D[8 ky + kx][u]
// through shared memory, then output row r - ky of plane j gains sum_kx
// Z[ky][x + kx], kx in order
__device__ __forceinline__ void gather_finish(float (&acc)[40], float* Z, float* Y, uint32_t full0,
                                              uint32_t empty0, uint32_t L, int S, int& released,
                                              int& waited, int upto, int j, int r, int rn, int xn,
                                              int q, int tq, int wq, int g, int t4) {
#pragma unroll
  for (int i = 0; i < 40; ++i) pin(acc[i]);
  gather_release(full0, empty0, L, S, released, waited, upto);
  bar_sync(3 + q, 128);  // the last item's reads of Z are done
#pragma unroll
  for (int jn = 0; jn < 10; ++jn)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ky = 2 * wq + h, kx = g;
      if (ky < 7 && kx < 7)
        *reinterpret_cast<float2*>(Z + (ky * 7 + kx) * kZRow + 8 * jn + 2 * t4) =
            make_float2(acc[4 * jn + 2 * h], acc[4 * jn + 2 * h + 1]);
    }
  bar_sync(3 + q, 128);
  for (int e = tq; e < 7 * xn; e += 128) {
    const int ky = e / xn, xl = e - ky * xn, yo = r - ky;
    if (yo < 0 || yo >= rn) continue;
    const float* zr = Z + ky * 7 * kZRow + xl;
    float s = 0.f;
#pragma unroll
    for (int kx = 0; kx < 7; ++kx) s += zr[kx * kZRow + kx];
    Y[((yo % 7) * kGMaxDepth + j) * kGSlots + xl] += s;
  }
}

// the consumers load channels [c0, c1) (at most two groups) of the weights:
// A[g][kz][8 ky + kx][c % 32] = W[c0 + 32 g + c, kz, ky, kx]; inlined or a
// call as spread_weights
__device__ __forceinline__ void gather_weights(const uint16_t* __restrict__ w, int c0, int c1,
                                               unsigned char* wA, int tid, int consumers) {
  bar_sync(2, consumers);  // every wgmma on the last chunk's weights is done
  zero_bytes(wA, (c1 - c0 + kGroup - 1) / kGroup * kGWeightBytes, tid, consumers);
  bar_sync(2, consumers);
  scatter_weights(w, c0, c1, wA, tid, consumers, [](int c, int tap) {
    const int kz = tap / 49, m = 8 * ((tap / 7) % 7) + tap % 7;
    return ((c / kGroup) * 7 + kz) * (64 * kSlotBytes) + chunk_offset(m, (c & 31) >> 3) +
           (c & 7) * 2;
  });
  fence_proxy_async();
  bar_sync(2, consumers);
}

__device__ __noinline__ void gather_weights_call(const uint16_t* __restrict__ w, int c0, int c1,
                                                 unsigned char* wA, int tid, int consumers) {
  gather_weights(w, c0, c1, wA, tid, consumers);
}

// kG channel groups a chunk; kChunked: C > 64, every row runs through the
// chunks (else one chunk, its weights loaded once)
template <int kG, bool kChunked>
__global__ void __launch_bounds__(gather_threads(kG), 1)
conv7_gather_kernel(const __grid_constant__ CUtensorMap in_map, const uint16_t* __restrict__ x,
                    const uint16_t* __restrict__ w, const uint16_t* __restrict__ bias,
                    uint16_t* __restrict__ y, int Di, int Hi, int Wi, int Do, int Ho, int Wo,
                    int C, int pad, int vec, int zt, int rt, int xt, int nz, int ny, int nx,
                    int tiles) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  static_assert(!kChunked || kG == 1, "C > 64 runs a group at a time");
  constexpr int groups = kG, kWG = gather_warpgroups(kG), consumers = 128 * kWG;
  constexpr int S = gather_stages(groups);
  constexpr int stage_bytes = groups * kGRowBytes;
  const int chunks = kChunked ? (C + kGroup - 1) / kGroup : 1;  // each row runs through them all
  unsigned char* wA = smem;                                   // groups x [7 kz][64 m][64 B]
  unsigned char* ring = wA + groups * kGWeightBytes;          // S stages x groups x [80][64 B]
  float* Zall = reinterpret_cast<float*>(ring + S * stage_bytes);  // kWG x [49][88]
  float* Y = Zall + kWG * 49 * kZRow;                              // [7][16][80]
  uint64_t* bars = reinterpret_cast<uint64_t*>(Y + 7 * kGMaxDepth * kGSlots);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + S);
  const uint32_t ring_s = smem_u32(ring);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);      // the producer's one arrival (with TMA's bytes)
      mbar_init(empty0 + 8 * s, consumers / 32);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int64_t in_plane = (int64_t)Hi * Wi;
  if (warp == 4 * kWG) {
    // producer: for each tile, each live input row, each chunk of channels,
    // the tile's Zt + 6 planes in order
    uint32_t L = 0;  // loads so far: stage L % S, its (L / S)-th use
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int n, z0, y0, x0;
      tile_origin(t, zt, rt, xt, nz, ny, nx, n, z0, y0, x0);
      const int zn = min(zt, Do - z0), rn = min(rt, Ho - y0);
      for (int r = 0; r < rn + 6; ++r) {
        const int yi = y0 - pad + r;
        if (yi < 0 || yi >= Hi) continue;
        for (int e = 0; e < chunks * (zn + 6); ++e, ++L) {
          const int p = kChunked ? e % (zn + 6) : e;  // the plane, and the chunk's first channel
          const int cg = kChunked ? gather_chunk(yi, e / (zn + 6), chunks) * kGroup : 0;
          const int st = L % S;
          const uint32_t full = full0 + 8 * st, dst = ring_s + st * stage_bytes;
          mbar_wait(empty0 + 8 * st, ((L / S) & 1) ^ 1);
          const int zi = z0 - pad + p;
          if (zi < 0 || zi >= Di) {  // outside the box: zeros (TMA's depth runs on into n + 1)
            for (int i = 16 * lane; i < stage_bytes; i += 16 * 32)
              *reinterpret_cast<uint4*>(ring + st * stage_bytes + i) = make_uint4(0, 0, 0, 0);
            fence_proxy_async();
            __syncwarp();
            if (lane == 0) mbar_arrive(full);
          } else if (vec) {
            if (lane == 0) {
              mbar_expect_tx(full, stage_bytes);
              for (int gr = 0; gr < groups; ++gr)
                tma_load_4d(dst + gr * kGRowBytes, &in_map, full, cg + gr * kGroup, x0 - pad,
                            yi, n * Di + zi);
            }
          } else {
            const uint16_t* row = x + ((n * (int64_t)Di + zi) * in_plane + (int64_t)yi * Wi) * C;
            for (int f = lane; f < groups * kGSlots * 4; f += 32) {
              const int q = f & 3, u = (f >> 2) % kGSlots, gr = (f >> 2) / kGSlots;
              const int gx = x0 - pad + u, c0 = cg + gr * kGroup + 8 * q;
              union {
                uint4 v;
                uint16_t h[8];
              } v;
#pragma unroll
              for (int k = 0; k < 8; ++k)
                v.h[k] = (gx >= 0 && gx < Wi && c0 + k < C) ? row[(int64_t)gx * C + c0 + k]
                                                           : (uint16_t)0;
              *reinterpret_cast<uint4*>(ring + st * stage_bytes + gr * kGRowBytes +
                                        chunk_offset(u, q)) = v.v;
            }
            fence_proxy_async();
            __syncwarp();
            if (lane == 0) mbar_arrive(full);
          }
          __syncwarp();  // the lanes stay together: none spins ahead on a later stage
        }
      }
    }
    return;
  }

  // the weights: once a block where C <= 64, else where a row enters another group
  for (int i = tid; i < 7 * kGMaxDepth * kGSlots; i += consumers) Y[i] = 0.f;
  if (!kChunked) gather_weights(w, 0, C, wA, tid, consumers);
  const int q = tid >> 7, tq = tid & 127, wq = tq >> 5, g = lane >> 2, t4 = lane & 3;
  float* Z = Zall + q * 49 * kZRow;
  const uint32_t wA_s = smem_u32(wA);
  const float b = bias ? bf2f(bias[0]) : 0.f;
  uint32_t L = 0;
  int loaded = -1;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    int n, z0, y0, x0;
    tile_origin(t, zt, rt, xt, nz, ny, nx, n, z0, y0, x0);
    const int zn = min(zt, Do - z0), rn = min(rt, Ho - y0), xn = min(xt, Wo - x0);
    const int np = zn + 6;
    for (int r = 0; r < rn + 6; ++r) {
      const int yi = y0 - pad + r;
      for (int i = 0; yi >= 0 && yi < Hi && i < chunks; ++i) {
        if (kChunked && gather_chunk(yi, i, chunks) != loaded) {
          loaded = gather_chunk(yi, i, chunks);
          gather_weights_call(w, loaded * kGroup, min(C, (loaded + 1) * kGroup), wA, tid,
                              consumers);
        }
        // this warpgroup's items j = q, q + kWG, ...; planes [0, released)
        // of the row are handed back, planes [0, waited) have landed
        int released = 0, waited = 0;
        gather_release(full0, empty0, L, S, released, waited, q < zn ? q : np);
        for (int j = q; j < zn; j += kWG) {
          float acc[40];
          gather_issue<kG, S>(acc, ring_s, wA_s, full0, L, j, waited);
          wg_wait<0>();
          gather_finish(acc, Z, Y, full0, empty0, L, S, released, waited,
                        j + kWG < zn ? j + kWG : np, j, r, rn, xn, q, tq, wq, g, t4);
        }
        L += np;
      }
      // output row r - 6 is complete on this warpgroup's planes (only their
      // items add to them): written, its row of Y zeroed (the next addition
      // to it follows the barrier that opens the next item's epilogue)
      const int yo = r - 6;
      if (yo >= 0 && yo < rn) {
        bar_sync(3 + q, 128);
        float* Yr = Y + (yo % 7) * kGMaxDepth * kGSlots;
        uint16_t* yrow = y + ((int64_t)n * Do + z0) * Ho * Wo + (int64_t)(y0 + yo) * Wo + x0;
        const int mine = (zn - q + kWG - 1) / kWG;  // planes q, q + kWG, ... below zn
        for (int e = tq; e < mine * xn; e += 128) {
          const int jj = q + (e / xn) * kWG, xl = e % xn;
          float* v = Yr + jj * kGSlots + xl;
          yrow[(int64_t)jj * Ho * Wo + xl] = f2bf(*v + b);
          *v = 0.f;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// weight gradient: D[c, k] = sum_n sum_u F[n, u, c] * S[n, u + k + kOff]

constexpr int kWTZ = 8, kWTY = 2;               // a tile: z planes x y rows x a row segment
constexpr int kWMaxSeg = 72;                    // longest row segment (even)
constexpr int kWSlots = (kWTY * kWMaxSeg + 15) / 16 * 16;  // 144 voxel slots a plane
constexpr int kWPlaneBytes = kWSlots * kSlotBytes;         // 9,216
constexpr int kWFieldStage = kWTZ * kWPlaneBytes;          // 73,728
constexpr int kWHZ = kWTZ + 6, kWHY = kWTY + 6;  // the one-channel halo's planes and rows
constexpr int kWHX = kWMaxSeg + 8;              // its row stride in pair words
constexpr int kWPStage = kWHZ * kWHY * kWHX * 4;  // 35,840
constexpr int kWLoads = 3;  // halo words a producer lane loads a row: 16 lanes a row, 48 >= 41
constexpr int kWStages = 2;                     // the ring
constexpr int kWConsumers = 2;                  // consumer warpgroups: a partial sum each
constexpr int kWThreads = 128 * kWConsumers + 128;  // and a producer warpgroup
constexpr int kWSmem = 1024 + kWStages * (kWFieldStage + kWPStage) + kWSlots / 2 * 4 +
                       2 * kWStages * 8;
constexpr int kWRows = 49, kWCols = 8;  // a partial: (kz, ky) rows x 8 kx a channel
constexpr int kWPartial = kGroup * kWRows * kWCols;
constexpr int kReduceThreads = 256;
static_assert(kWSmem <= kMaxSmem, "two stages of a tile and its halo fit");
static_assert(kWHZ % 2 == 0, "the A registers' double buffer runs on across k-steps");
static_assert(kWHY == 2 * 4, "the producer's warps: two halo rows each");
static_assert(16 * kWLoads >= (kWMaxSeg + 8) / 2 + 1, "a row's halo words in the loads");

// a wgmma operand descriptor for an MN-major tile: per K index (a voxel) one
// 64-byte row of 32 N values (channels) under the 64-byte swizzle, 8-row
// groups 512 bytes apart. With N = 32 one swizzle atom spans all of N, so
// the offset between atoms along N is never used; it is 512 as well.
__device__ __forceinline__ uint64_t desc_mn_sw64(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(512 >> 4) << 16) |
         ((uint64_t)(512 >> 4) << 32) | ((uint64_t)2 << 62);
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

// One block's partial sums over its tiles (tile = blockIdx.x, + gridDim.x,
// ...) for channel group blockIdx.y, one per consumer warpgroup:
// partial[kWConsumers * block + q][group][c][kz * 7 + ky][kx]. F is the
// C-channel field (N, Fd, Fh, Fw, C), through field_map where vec (TMA,
// box (32, xt, kWTY, 1, 1)); S the one-channel field (N, Sd, Sh, Sw), zero
// outside its box, in 32-bit words where `granules`; u runs over F's box
// in tiles of kWTZ planes x kWTY rows x a row segment of xt (even) voxels.
template <int kOff>
__device__ __forceinline__ void wgrad_body(const CUtensorMap* field_map,
                                           const uint16_t* __restrict__ field,
                                           const uint16_t* __restrict__ one,
                                           float* __restrict__ partial, int Fd, int Fh, int Fw,
                                           int Sd, int Sh, int Sw, int C, int vec, int granules,
                                           int xt, int nz, int ny, int nx, int tiles) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* fieldb = smem;  // kWStages x kWTZ planes x [kWSlots voxels][64 B]
  uint32_t* Pw = reinterpret_cast<uint32_t*>(fieldb + kWStages * kWFieldStage);
  int* table = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(Pw) + kWStages * kWPStage);
  uint64_t* bars = reinterpret_cast<uint64_t*>(table + kWSlots / 2);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + kWStages);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cg = blockIdx.y * kGroup;  // the group's first channel

  if (tid == 0) {
    for (int s = 0; s < kWStages; ++s) {
      // every producer thread once its halo words are written, and the
      // TMA's expect-tx arrival where the field comes by TMA
      mbar_init(full0 + 8 * s, 128 + (vec ? 1 : 0));
      mbar_init(empty0 + 8 * s, 128 * kWConsumers);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the slots past a plane's kWTY x xt voxels stay zero (TMA fills only the
  // box); voxel pair p of a plane, (2p, 2p + 1) at row y, column x, reads
  // halo word y * kWHX + x at tap (0, 0, 0) (past the voxels: word 0, whose
  // field is zero)
  zero_bytes(fieldb, kWStages * kWFieldStage, tid, kWThreads);
  for (int p = tid; p < kWSlots / 2; p += kWThreads) {
    const int v = 2 * p;
    table[p] = v < kWTY * xt ? (v / xt) * kWHX + v % xt : 0;
  }
  fence_proxy_async();
  __syncthreads();

  if (warp >= 4 * kWConsumers) {
    // producer warpgroup: each tile's field (TMA, or its threads) and its
    // halo as pair words P[h][r][i] = (T[h][r][i], T[h][r][i + 1]) of the
    // raw halo T. Lane l of warp pw takes halo row r = 2 pw + l / 16 and its
    // 32-bit words j = l % 16 + 16 i (T[2j], T[2j + 1]) of every plane,
    // loaded into registers all at once; word j + 1 comes from the next lane
    const int64_t splane = (int64_t)Sh * Sw;
    const int pw = warp - 4 * kWConsumers, ptid = tid - 128 * kWConsumers;
    const int r = 2 * pw + (lane >> 4), jl = lane & 15;
    const int pairs = (xt + 8) / 2;  // word pairs a row: P words 0 .. xt + 7
    int k = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++k) {
      int n, z0, y0, x0;
      tile_origin(t, kWTZ, kWTY, xt, nz, ny, nx, n, z0, y0, x0);
      const int s = k % kWStages;
      const uint32_t full = full0 + 8 * s;
      mbar_wait(empty0 + 8 * s, ((k / kWStages) & 1) ^ 1);
      unsigned char* fs = fieldb + s * kWFieldStage;
      if (vec) {
        if (ptid == 0) {
          mbar_expect_tx(full, kWTZ * kWTY * xt * kSlotBytes);
          for (int pz = 0; pz < kWTZ; ++pz)
            tma_load_5d(smem_u32(fs + pz * kWPlaneBytes), field_map, full, cg, x0, y0, z0 + pz,
                        n);
        }
      } else {
        // 16-byte chunks of 8 channels, zero outside the box or past C
        const uint16_t* fn = field + (int64_t)n * Fd * Fh * Fw * C;
        for (int e = ptid; e < kWTZ * kWTY * xt * 4; e += 128) {
          const int q = e & 3, v = (e >> 2) % (kWTY * xt), pz = (e >> 2) / (kWTY * xt);
          const int gx = x0 + v % xt, gy = y0 + v / xt, gz = z0 + pz, c = cg + 8 * q;
          const bool inside = gx < Fw && gy < Fh && gz < Fd;
          const int64_t src = inside ? (((int64_t)gz * Fh + gy) * Fw + gx) * C + c : 0;
          union {
            uint4 v;
            uint16_t h[8];
          } u;
#pragma unroll
          for (int e2 = 0; e2 < 8; ++e2)
            u.h[e2] = (inside && c + e2 < C) ? fn[src + e2] : (uint16_t)0;
          *reinterpret_cast<uint4*>(fs + pz * kWPlaneBytes + chunk_offset(v, q)) = u.v;
        }
        fence_proxy_async();
      }
      const uint16_t* sn = one + (int64_t)n * Sd * splane;
      const int gy = y0 + r + kOff;
      uint32_t word[kWHZ][kWLoads];
#pragma unroll
      for (int h = 0; h < kWHZ; ++h) {
        const int gz = z0 + h + kOff;
        const bool live = gy >= 0 && gy < Sh && gz >= 0 && gz < Sd;
        const uint16_t* row = sn + (live ? gz * splane + (int64_t)gy * Sw : 0);
#pragma unroll
        for (int i = 0; i < kWLoads; ++i) {
          const int gx = x0 + kOff + 2 * (jl + 16 * i);
          if (granules) {  // Sw even, gx even: a word is inside or outside whole
            word[h][i] = (live && gx >= 0 && gx < Sw)
                             ? *reinterpret_cast<const uint32_t*>(row + gx) : 0u;
          } else {
            word[h][i] = pack((live && gx >= 0 && gx < Sw) ? row[gx] : (uint16_t)0,
                              (live && gx + 1 >= 0 && gx + 1 < Sw) ? row[gx + 1] : (uint16_t)0);
          }
        }
      }
      uint32_t* Ps = Pw + s * (kWPStage / 4) + r * kWHX;
#pragma unroll
      for (int h = 0; h < kWHZ; ++h)
#pragma unroll
        for (int i = 0; i < kWLoads; ++i) {
          // lane jl + 1 holds word j + 1; lane 0 of the row hands lane 15 its next word
          const uint32_t give = (jl == 0 && i + 1 < kWLoads) ? word[h][i + 1] : word[h][i];
          const uint32_t next = __shfl_sync(0xffffffffu, give, (lane & 16) | ((jl + 1) & 15));
          const int j = jl + 16 * i;
          if (j < pairs)
            *reinterpret_cast<uint2*>(Ps + h * kWHY * kWHX + 2 * j) =
                make_uint2(word[h][i], __byte_perm(word[h][i], next, 0x5432));
        }
      mbar_arrive(full);
    }
    return;
  }

  // consumers: warpgroup q takes the tile's k-steps (16 voxels of a plane)
  // ks = (q + k) % 2, + 2, ... (the odd one alternates between tiles). A
  // thread's rows m = 16 w + g (ky = 2 w, kx = g) and m + 8 (ky = 2 w + 1;
  // ky 7 reads row 6 and is dropped); its columns the voxel pairs t4 and t4
  // + 4 of the k-step, whose halo words the table gives
  const int q = warp >> 2, w = warp & 3, g = lane >> 2, t4 = lane & 3;
  const int wr0 = 2 * w * kWHX + g, wr1 = min(2 * w + 1, 6) * kWHX + g;
  const int nks = (kWTY * xt + 15) >> 4;
  float acc[7][16];
#pragma unroll
  for (int i = 0; i < 7; ++i)
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[i][e] = 0.f;
#pragma unroll
  for (int i = 0; i < 7; ++i)
#pragma unroll
    for (int e = 0; e < 16; ++e) pin(acc[i][e]);
  uint32_t af[2][4];
  const uint32_t field_s = smem_u32(fieldb);
  int k = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++k) {
    const int s = k % kWStages;
    mbar_wait(full0 + 8 * s, (k / kWStages) & 1);
    const uint32_t* Ps = Pw + s * (kWPStage / 4);
    const uint64_t d0 = desc_mn_sw64(field_s + s * kWFieldStage);
    for (int ks = (q + k) & 1; ks < nks; ks += 2) {
      const int b0 = table[8 * ks + t4], b1 = table[8 * ks + t4 + 4];
      const uint32_t* p00 = Ps + b0 + wr0;
      const uint32_t* p01 = Ps + b0 + wr1;
      const uint32_t* p10 = Ps + b1 + wr0;
      const uint32_t* p11 = Ps + b1 + wr1;
      const uint64_t dk = d0 + ks * (16 * kSlotBytes >> 4);
      // halo plane h feeds tile plane pz at kz = h - pz: each A fragment is
      // loaded once for every kz that reads it
#pragma unroll
      for (int h = 0; h < kWHZ; ++h) {
        uint32_t(&a)[4] = af[h & 1];
        a[0] = p00[h * kWHY * kWHX];
        a[1] = p01[h * kWHY * kWHX];
        a[2] = p10[h * kWHY * kWHX];
        a[3] = p11[h * kWHY * kWHX];
        wg_fence();
#pragma unroll
        for (int pz = 0; pz < kWTZ; ++pz) {
          const int kz = h - pz;
          if (kz < 0 || kz > 6) continue;
          wgmma_m64n32k16_rs<1>(acc[kz], a, dk + pz * (kWPlaneBytes >> 4));
        }
        wg_commit();
        wg_wait<1>();  // step h - 1 is done: its A registers may be reused
#pragma unroll
        for (int e = 0; e < 4; ++e) pin(af[(h + 1) & 1][e]);
      }
    }
    wg_wait<0>();  // every wgmma on this stage is done
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      pin(af[0][e]);
      pin(af[1][e]);
    }
    mbar_arrive(empty0 + 8 * s);
  }
#pragma unroll
  for (int i = 0; i < 7; ++i)
#pragma unroll
    for (int e = 0; e < 16; ++e) pin(acc[i][e]);

  float* out = partial +
               ((int64_t)(kWConsumers * blockIdx.x + q) * gridDim.y + blockIdx.y) * kWPartial;
#pragma unroll
  for (int kz = 0; kz < 7; ++kz)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int ky = 2 * w + hh;
      if (ky > 6) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 8 * j + 2 * t4, r = kz * 7 + ky;
        out[(c * kWRows + r) * kWCols + g] = acc[kz][4 * j + 2 * hh];
        out[((c + 1) * kWRows + r) * kWCols + g] = acc[kz][4 * j + 2 * hh + 1];
      }
    }
}

// the stem: F = the output gradient (box Fd), S = the input (box Fd + 6), kOff 0
__global__ void __launch_bounds__(kWThreads, 1)
conv7_wgrad_spread_kernel(const __grid_constant__ CUtensorMap field_map,
                          const uint16_t* __restrict__ g, const uint16_t* __restrict__ a,
                          float* __restrict__ partial, int Fd, int Fh, int Fw, int C, int vec,
                          int granules, int xt, int nz, int ny, int nx, int tiles) {
  wgrad_body<0>(&field_map, g, a, partial, Fd, Fh, Fw, Fd + 6, Fh + 6, Fw + 6, C, vec, granules,
                xt, nz, ny, nx, tiles);
}

// the head: F = the input (box Fd), S = the output gradient (box Fd - 6),
// kOff -6; D[c, k] is dW[c, 342 - k], flipped by the reduce
__global__ void __launch_bounds__(kWThreads, 1)
conv7_wgrad_gather_kernel(const __grid_constant__ CUtensorMap field_map,
                          const uint16_t* __restrict__ x, const uint16_t* __restrict__ g,
                          float* __restrict__ partial, int Fd, int Fh, int Fw, int C, int vec,
                          int granules, int xt, int nz, int ny, int nx, int tiles) {
  wgrad_body<-6>(&field_map, x, g, partial, Fd, Fh, Fw, Fd - 6, Fh - 6, Fw - 6, C, vec, granules,
                 xt, nz, ny, nx, tiles);
}

// dW[c, k] = sum over the `blocks` partials (one per consumer warpgroup of
// each first-pass block), in order (four interleaved sums joined as (s0 +
// s1) + (s2 + s3)), of partial[b][c][tap], the tap k or 342 - k
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

// the spread's and the gather's instances for c channels, and the groups a
// spread tile holds
int spread_chunk_groups(int c) {
  const int groups = (c + kGroup - 1) / kGroup;
  return groups > kMaxGroups ? 1 : groups;
}

auto spread_kernel(int c) -> decltype(&conv7_spread_kernel<false>) {
  return c > kGroup * kMaxGroups ? conv7_spread_kernel<true> : conv7_spread_kernel<false>;
}

auto gather_kernel(int c) -> decltype(&conv7_gather_kernel<1, false>) {
  const int groups = (c + kGroup - 1) / kGroup;
  return groups == 2 ? conv7_gather_kernel<2, false>
                     : groups == 1 ? conv7_gather_kernel<1, false> : conv7_gather_kernel<1, true>;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
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
// (multiples of 16), the box, the 64-byte swizzle, zeros outside the tensor.
cudaError_t make_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                     const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
                        dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* mra_conv7_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Blocks of the spread (kind 0), the gather (kind 1) or a weight gradient's
// first pass (kind 2) the card holds at once for c channels: the persistent
// grid's largest useful size. Minus a CUDA error on failure.
int mra_conv7_resident(int kind, int c) {
  if (c < 1 || kind < 0 || kind > 2) return -(int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (kind == 1) {
    const int groups = gather_chunk_groups(c);
    const auto kernel = gather_kernel(c);
    if (e == cudaSuccess) e = allow_smem(kernel, gather_smem(groups));
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, gather_threads(groups),
                                                        gather_smem(groups));
  } else if (kind == 2) {  // the stem's and the head's instances take the same resources
    if (e == cudaSuccess) e = allow_smem(conv7_wgrad_gather_kernel, kWSmem);
    if (e == cudaSuccess) e = allow_smem(conv7_wgrad_spread_kernel, kWSmem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv7_wgrad_spread_kernel,
                                                        kWThreads, kWSmem);
  } else {
    const auto kernel = spread_kernel(c);
    const int smem = spread_smem(spread_chunk_groups(c));
    if (e == cudaSuccess) e = allow_smem(kernel, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kSpreadThreads, smem);
  }
  if (e != cudaSuccess) return -(int)e;
  return sms * (per_sm > 0 ? per_sm : 1);
}

// a (N, Di, Hi, Wi) bf16; w (C, 343) bf16; bias (C) bf16 or null;
// y (N, Do, Ho, Wo, C) bf16 with Do = Di + 2 pad - 6 (and H, W so); tiles of
// 4 x 4 x 16 (z, y, x) outputs of a chunk of channels (all of them where C
// <= 64, else one group of 32), nz x ny x nx a sample and chunk (the chunk
// the slowest index), walked by `grid` blocks;
// vec: y is stored by TMA (C % 8 == 0, y 16-byte aligned); granules: a is
// copied in 4-byte granules (Wi even, a 4-byte aligned)
int mra_conv7_spread(const void* a, const void* w, const void* bias, void* y, int n, int di,
                     int hi, int wi, int c, int pad, int vec, int granules, int grid, int nz,
                     int ny, int nx, void* stream) {
  const int d_o = di + 2 * pad - 6, h_o = hi + 2 * pad - 6, w_o = wi + 2 * pad - 6;
  const int groups = (c + kGroup - 1) / kGroup;
  if (groups < 1) return (int)cudaErrorInvalidValue;
  const auto kernel = spread_kernel(c);
  const int smem = spread_smem(spread_chunk_groups(c));
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if (vec) {
    const cuuint64_t row = (cuuint64_t)c * 2;
    const cuuint64_t dims[5] = {(cuuint64_t)c, (cuuint64_t)w_o, (cuuint64_t)h_o, (cuuint64_t)d_o,
                                (cuuint64_t)n};
    const cuuint64_t strides[4] = {row, row * w_o, row * w_o * h_o, row * w_o * h_o * d_o};
    const cuuint32_t box[5] = {kGroup, kSX, kSY, kSZ, 1};
    e = make_map(&map, y, 5, dims, strides, box);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, kSpreadThreads, smem, (cudaStream_t)stream>>>(
      map, (const uint16_t*)a, (const uint16_t*)w, (const uint16_t*)bias, (uint16_t*)y, di, hi,
      wi, d_o, h_o, w_o, c, pad, vec, granules, nz, ny, nx,
      groups / spread_chunk_groups(c) * n * nz * ny * nx);
  return (int)cudaGetLastError();
}

// x (N, Di, Hi, Wi, C) bf16; w (C, 343) bf16; bias (1) bf16 or null;
// y (N, Do, Ho, Wo) bf16 with Do = Di + 2 pad - 6 (and H, W so); tiles of
// zt output planes x rt rows x a segment of xt (<= 74) outputs, nz x ny x nx
// a sample, walked by `grid` blocks; vec: x is read by TMA (C % 8 == 0, x
// 16-byte aligned)
int mra_conv7_gather(const void* x, const void* w, const void* bias, void* y, int n, int di,
                     int hi, int wi, int c, int pad, int vec, int grid, int zt, int rt, int xt,
                     int nz, int ny, int nx, void* stream) {
  const int d_o = di + 2 * pad - 6, h_o = hi + 2 * pad - 6, w_o = wi + 2 * pad - 6;
  const int groups = gather_chunk_groups(c);
  if (c < 1 || zt < 1 || zt > kGMaxDepth || xt < 1 || xt > kGMaxSegment || rt < 1)
    return (int)cudaErrorInvalidValue;
  const auto kernel = gather_kernel(c);
  cudaError_t e = allow_smem(kernel, gather_smem(groups));
  if (e != cudaSuccess) return (int)e;
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if (vec) {
    const cuuint64_t row = (cuuint64_t)c * 2;
    const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)wi, (cuuint64_t)hi,
                                (cuuint64_t)di * n};
    const cuuint64_t strides[3] = {row, row * wi, row * wi * hi};
    const cuuint32_t box[4] = {kGroup, kGSlots, 1, 1};
    e = make_map(&map, x, 4, dims, strides, box);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, gather_threads(groups), gather_smem(groups), (cudaStream_t)stream>>>(
      map, (const uint16_t*)x, (const uint16_t*)w, (const uint16_t*)bias, (uint16_t*)y, di, hi,
      wi, d_o, h_o, w_o, c, pad, vec, zt, rt, xt, nz, ny, nx, n * nz * ny * nx);
  return (int)cudaGetLastError();
}

// The first pass of a weight gradient: partial sums (kWConsumers * grid,
// ceil(c / 32) * 32, 49, 8) float32, `grid` blocks a channel group, each
// walking tiles blockIdx.x, + grid, ... of kWTZ planes x kWTY rows x xt
// voxels (xt even, <= kWMaxSeg), nz x ny x nx a sample, of the field's box
// (n, fd, fh, fw). The stem (head 0): field = g (N, fd, fh, fw, c) the
// output gradient, one = a (N, fd + 6, fh + 6, fw + 6) the input. The head
// (head 1): field = x (N, fd, fh, fw, c) the input, one = g (N, fd - 6, fh -
// 6, fw - 6) the output gradient, its taps flipped. All bf16. vec: the field
// is read by TMA (c % 8 == 0, 16-byte aligned); granules: the one-channel
// field is read in 4-byte words (its width even, 4-byte aligned).
int mra_conv7_wgrad(int head, const void* field, const void* one, void* partial, int grid, int n,
                    int fd, int fh, int fw, int c, int vec, int granules, int xt, int nz, int ny,
                    int nx, void* stream) {
  if (c < 1 || grid < 1 || xt < 2 || xt > kWMaxSeg || xt % 2) return (int)cudaErrorInvalidValue;
  const auto kernel = head ? conv7_wgrad_gather_kernel : conv7_wgrad_spread_kernel;
  cudaError_t e = allow_smem(kernel, kWSmem);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if (vec) {
    const cuuint64_t row = (cuuint64_t)c * 2;
    const cuuint64_t dims[5] = {(cuuint64_t)c, (cuuint64_t)fw, (cuuint64_t)fh, (cuuint64_t)fd,
                                (cuuint64_t)n};
    const cuuint64_t strides[4] = {row, row * fw, row * fw * fh, row * fw * fh * fd};
    const cuuint32_t box[5] = {kGroup, (cuuint32_t)xt, kWTY, 1, 1};
    e = make_map(&map, field, 5, dims, strides, box);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 blocks(grid, (c + kGroup - 1) / kGroup);
  kernel<<<blocks, kWThreads, kWSmem, (cudaStream_t)stream>>>(
      map, (const uint16_t*)field, (const uint16_t*)one, (float*)partial, fd, fh, fw, c, vec,
      granules, xt, nz, ny, nx, n * nz * ny * nx);
  return (int)cudaGetLastError();
}

// The second pass: dw (c, 343) bf16 from `blocks` partial sums, the taps
// flipped (342 - k) where flip is set.
int mra_conv7_wgrad_reduce(const void* partial, void* dw, int blocks, int c, int flip,
                           void* stream) {
  const int grid = (c * kTaps + kReduceThreads - 1) / kReduceThreads;
  conv7_wgrad_reduce_kernel<<<grid, kReduceThreads, 0, (cudaStream_t)stream>>>(
      (const float*)partial, (uint16_t*)dw, blocks, c, flip);
  return (int)cudaGetLastError();
}

}  // extern "C"
