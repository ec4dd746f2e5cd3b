// The bf16 route of conv3x3.cu: the fused 3x3 SAME conv + affine + ReLU as an
// implicit GEMM on Hopper's tensor cores (bf16 in, f32 accumulation). It
// replaces the TPU kernels conv3x3_affine (kpvid_tpu/ops/pallas_conv.py:158,
// #1) and up2_conv3_affine (pallas_conv.py:434, #2): one template, UP2 runs
// the same main loop on the phase form of #2, see there. ADD
// (conv3x3_add_bf16_mma_kernel, #1+) adds an f32 addend in the epilogue, see
// there.
//
// Design: a persistent, warp-specialised kernel. The grid is one block an SM
// (fewer when there are fewer tiles); block b walks the output tiles b, b +
// grid, b + 2 grid, ... of [N][tile rows][tile columns][Cout / TN]. A block is
// three warpgroups:
//   - the producer (warpgroup 0) fills a ring of STAGES (3 or more) stages in
//     shared memory, one stage per CK = 16 input channels of one tile, and
//     runs ahead across tiles, so the next tile's first stages load while the
//     consumers run this tile's epilogue;
//   - two consumer warpgroups run wgmma on each stage and keep the tile's
//     accumulators in registers (128 f32 a thread).
// ptxas gives every thread the launch bound's 168 registers whatever
// setmaxnreg would move at run time (a 512-thread block, 128 a thread, does
// not compile the m64n256 accumulators), so the block has one producer
// warpgroup and no setmaxnreg.
// A stage's full and empty mbarriers are the only synchronisation in the
// loop: the producer waits for `empty`, the consumers for `full`; nothing
// calls __syncthreads after the barriers are set up.
//
// Both operands come from shared memory through descriptors (wgmma's SS
// form), so no instruction but a wgmma writes a register that a wgmma reads
// and ptxas keeps them pipelined (with A in registers, loaded by ldmatrix
// while earlier wgmmas run, it serialises every wgmma). A stage holds
//   - the weight slice [9 taps * CK][TN] bf16, output channels innermost, in
//     the canonical MN-major layout with the 128-byte swizzle (64-channel
//     atoms of [144 rows][128 B], chunk j of row r at chunk j ^ (r % 8)), one
//     3-D TMA box {64, CK, 9} an atom, which zero-fills channels past C and
//     Cout; for TN = 8 (the 4-channel head: Cout % 8 != 0, rows TMA cannot
//     stride) one unswizzled 16-byte row per k, stored element-wise by the
//     producer only when the stage last held other weights;
//   - the (TH+2)-row halo of x at CK channels as three copies 16 pixels wide,
//     copy dx starting at halo column dx, one 32-byte K-major row a pixel with
//     the 32-byte swizzle (its two 16-byte chunks swapped on every other group
//     of 4 pixels, swz). A copy's rows are 16 pixels, like the output tile's,
//     so for tap (dy, dx) the pixels of output rows y.. are the consecutive
//     pixels of copy dx from row y + dy: a descriptor whose start moves by 512
//     bytes a row. Each copy is one 4-D TMA box {CK, 16, TH+2, 1} at signed
//     coordinates whose out-of-bounds zero fill is the SAME padding.
// C % 8 != 0 (rows that are not 16-byte vectors) takes an element-wise
// loader into the same copies, Cout % 8 != 0 element-wise weights, in the
// same ring.
//
// #2, the phase form (UP2). The TF1-legacy 2x upsample (u[2i] = x[i],
// u[2i+1] = (x[i] + x[i+1]) / 2, edge-clamped) followed by the SAME 3x3 conv
// is, for each output phase (a, b) in {0,1}^2, a 3x3 conv of the
// low-resolution x: out[2i+a][2j+b] = sum_{e,f} K_ab[e][f] x[i+e][j+f] with
// K_ab[e][f] = sum_{dy,dx} A_a[e][dy] A_b[f][dx] k[dy][dx] (the JAX
// reference's _up2_phase_kbig, pallas_conv.py:197; A_0 and A_1 at
// up2_phase_weights_kernel). So #2 is #1's main loop over the
// low-resolution grid at Cout' = 4 Fp output channels: the pixels the same
// TMA halo copies of x, the weights the [9 CK][128] slice of the phase
// weights K' [3][3][C][4 Fp] (channel o' = (2b + a) Fp + o, Fp = F rounded up
// to 64, so that each 64-channel atom holds one phase and each 128-channel
// tile one b), which up2_phase_weights_kernel makes from k in f32 and rounds
// once, in the same launch sequence. The epilogue writes low-resolution pixel
// (i, j) of phase (a, b) to output pixel (2i + a, 2j + b). Four phases of 9
// taps are the upsampled conv's 36 taps for a 2 x 2 block of output pixels;
// the kernel leaves out those whose weights are zero, A_1's row e = -1 and, for
// b = 1, column f = -1, and runs 25.
// The borders, exact before the one rounding. The phase form on x padded with
// zeros is wrong on output rows/columns {0, 2n-2, 2n-1}. Per axis, padding x
// with -x[0] before and +x[n-1] after (corners by product) makes every line
// exact but 2n-1 of phase 1, where tap d = +1 adds x[n-1] that the upsample's
// edge clamp and the conv's zero pad leave out. The producer warpgroup splits
// for it: its first warp issues each stage's TMA as soon as the stage is free
// (the copies complete a barrier of their own, `loaded`), its other three
// patch the pad lines of the edge tiles' copies once they have landed and
// then arrive on `full` (a producer that waited for each stage's copies
// before issuing the next stage's ran oct1a 29% slower on an H100). Those two
// surplus terms, and their overlap at the corner, go through the taps that are
// zero in the interior:
//   - row 2H-1: phase a = 1's slots e = -1 hold -sum_dx A_b[f][dx] k[+1][dx];
//     a = 1 tiles skip those slots' n256 wgmmas and, on the bottom tile row,
//     run them as m64n16k16 over the tile's last row (halo row TH, one per
//     f), accumulated into the registers of that row's 16 pixels;
//   - column 2W-1: phase b = 1's slots f = -1 hold -sum_dy A_a[e][dy]
//     k[dy][+1], and on the right tile column their n256 wgmmas read, for
//     copy 0, a column copy: zero but at the last column, which holds
//     x[:, W-1] with its patched pads (the producer copies it from copy 1
//     into a ring of NS such copies, zeroed once); elsewhere b = 1 tiles skip
//     them and load no copy 0;
//   - the corner: phase (1, 1)'s slot (-1, -1), which both rules leave at 0,
//     holds +k[+1][+1], read by the row term's f = -1 wgmma from the column
//     copy.
// Tiles are aligned to the bottom and right edges of the low-resolution grid
// (the first tile row and column may start above and left of the image), so
// the last image row and column are always the tile's row and column 15. A
// stage's weights come one TMA box a tap, only the taps its atoms read.
//
// The MMA, and the tile shapes (TH x TW output pixels x TN channels), from
// Cout:
//   - TN = 128 (Cout >= 128), 16 x 16 x 128, and TN = 64 (8 < Cout < 128),
//     32 x 16 x 64: channels on wgmma's M, pixels on N. Consumer warpgroup g
//     takes the 64 channels of atom g (TN = 128) or output rows 16g.. (TN =
//     64), 256 pixels, one m64n256k16 a tap, 9 a stage;
//   - TN = 8 (the head), 32 x 16 x 8: pixels on M, 4 m64 tiles (4 output rows
//     each) a warpgroup, m64n8k16.
// A stage's wgmmas are one commit group; the consumers wait for the previous
// stage's group only after issuing this one's, then release it (one arrival
// per warp).
//
// What bounds them, at the tensor cores' full rate of 4,096 FLOP a clock an
// SM, against shared memory's 128 B a clock: an m64n256k16 reads 2 KB of
// weights and 8 KB of pixels for 524,288 FLOP, 80 B a clock (an m64nNk16
// with the pixels on M reads 2 KB + 32 N bytes for 2,048 N FLOP: 96 B a clock
// at N = 128, 128 at N = 64, the reason for the transposed form). The stage
// fill (weights + the three copies) adds 28 B a clock at TN = 128 and 31 at
// TN = 64; the epilogue's staging 3.5-14. So #1 needs 112-125 B a clock and is
// bound by operations. #2 runs TN = 128 stages with 4 to 9 of their taps (on
// average 6.9 at oct1a's 32^2 grid, 6.6 at oct2a's 64^2), so its stage fill
// takes 28-41 B a clock beside the wgmmas' 80 at the rate of the taps it runs,
// plus the edge tiles' patch (the pad lines, a few hundred bytes a stage).
// The head is bound by reading x (2 x 64 bytes a pixel against 2 x 9 x 64 x 4
// FLOP). On an H100 the stages' fill from L2 (the copies' TMA rows are 32
// bytes) bounds them first: #1's wide layers and #2 take about the same time a
// stage whatever taps they run (PERF.md).
//
// The epilogue applies acc * scale + shift and the optional ReLU in
// registers, rounds once to bf16 and stages the tile in its last stage (held
// until then, while the producer fills the others with the next tile), from
// where each output row goes out in 16-byte vectors.
//
// #1+ (ADD, kpvid::conv3x3_add_affine) replaces no TPU kernel: the JAX path
// leaves the split first conv of the translator to XLA (kpvid_tpu/eval/
// final.py::_split_first_conv: a per-frame conv, a broadcast add of each
// sample's part, then oct0a's BN + ReLU in kpvid_tpu/ops/pallas_chain.py:90).
// Here that is one launch: the same main loop, and an epilogue that reads the
// f32 addend of the tile's sample (frame n takes addend row n / frames) and
// applies (acc + addend) * scale + shift, then the ReLU, before the one
// rounding. The addend adds 4 bytes an output element to the bytes a tile
// moves, served mostly from L2 (the 32 frames of a sample are neighbouring
// tiles); at the split conv's C = 40 the main loop is 3 stages a tile, so the
// read is not hidden behind wgmma by itself. Read in the accumulator's layout
// (two channels 8 apart, pixels 2 apart, a thread) it is 128 scattered loads a
// thread and a tile, and issuing it from the consumers, even as cp.async,
// takes registers the 128 accumulators do not leave (ptxas spilled; 1.69 and
// 1.26 ms at the split conv's shape against #1's 0.50). So the producer
// warpgroup's last warp fetches it (the stages go on from its other three):
// each consumer warpgroup has a ring of ANB buffers, one output row of its 256
// pixels (16 pixels x 64 channels, f32) each, behind full/empty mbarriers like
// the stages'; a row is two TMA boxes {32 channels, 16 pixels} with the
// 128-byte swizzle (chunk j of pixel p at j ^ (p % 8)), so that the epilogue's
// reads (8 channels of 4 pixels 2 apart a warp) hit every bank once, and the
// warp runs ANB rows ahead of the epilogue, into the next tile's first rows
// during its main loop. The rings take the third stage's shared memory: two
// stages, 12 rows a ring (0.79 ms; three stages and 4 rows spilled and ran
// 0.80, 8 rows 0.79: what is left over #1 is the epilogue's reads and waits
// on the rows' arrival, not the ring's depth). Two stages suit the split
// conv's 3 stages a tile; a long K would want more. An addend whose rows TMA
// cannot stride (Cout % 4 != 0) is copied element by element by the same warp
// into the same layout.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace kpvid_mma {

constexpr int TW = 16;  // output pixels a tile row, and a halo copy's row
constexpr int CK = 16;  // input channels a stage: one k16 step a tap
constexpr int PIX_B = CK * 2;  // bytes of one halo pixel: a 32-byte K-major row
constexpr int HW = TW + 2;
constexpr int ATOM_B = 9 * CK * 128;  // a 64-channel atom of a stage's weights
constexpr int NPT = 128;  // producer threads: one warpgroup
constexpr int NCONS = 2;  // consumer warpgroups
constexpr int NTHREADS = NPT + 128 * NCONS;
constexpr int SMEM_MAX = 232448;  // 227 KB, a block's most
constexpr int ANB_MAX = 12;  // ADD: rows of an addend ring

constexpr int align_up(int b, int a) { return (b + a - 1) / a * a; }
constexpr int min_i(int a, int b) { return a < b ? a : b; }

// the tile of a block and its shared memory: STAGES stages of [weights][three
// halo copies] (1024-byte aligned, for the swizzles), (UP2) a column copy a
// stage, the barriers, slack to align the base, and (ADD, TN >= 64) the
// addend rings of the consumer warpgroups in what is left
template <int TN, bool UP2, bool ADD = false>
struct Tile {
  // TN >= 64: channels on wgmma's M (64 an atom), the tile's pixels on N (256 a
  // warpgroup); the head: pixels on M, MT m64 tiles of 4 output rows a warpgroup
  static constexpr bool TRANS = TN >= 64;
  static constexpr int TH = TN == 128 ? 16 : 32;    // output rows a tile
  static constexpr int MT = TH / (4 * NCONS);
  static constexpr int COPY_B = (TH + 2) * TW * PIX_B;  // one halo copy
  static constexpr int HALO_B = 3 * COPY_B;
  static constexpr int W_B = TN >= 64 ? TN / 64 * ATOM_B : 9 * CK * TN * 2;
  static constexpr int HALO_OFF = align_up(W_B, 1024);
  static constexpr int STAGE_B = align_up(HALO_OFF + HALO_B, 1024);
  static constexpr int COL_B = UP2 ? COPY_B : 0;  // UP2: the stage's column copy
  static constexpr int EXTRA = 1024 + 128;  // + the barriers
  // ADD (TRANS): two stages, and after them each consumer warpgroup's ring of
  // ANB addend buffers (one output row: 16 pixels x 64 channels, f32, two
  // 1024-byte-aligned halves of 32 channels) and their barriers
  static constexpr bool ARING = ADD && TRANS;
  static constexpr int STAGES = ARING ? 2 : min_i(8, (SMEM_MAX - EXTRA) / (STAGE_B + COL_B));
  static constexpr int AROW_B = TW * 64 * 4;
  static constexpr int ABAR_B = 512;
  static constexpr int ANB =
      ARING ? min_i(ANB_MAX, (SMEM_MAX - STAGES * STAGE_B - EXTRA - ABAR_B) / (NCONS * AROW_B))
            : 0;
  static constexpr int ADD_B = ARING ? ANB * NCONS * AROW_B + ABAR_B : 0;
  static constexpr int BYTES = STAGES * (STAGE_B + COL_B) + EXTRA + ADD_B;
  static_assert(STAGES >= (ARING ? 2 : 3), "a ring of at least three stages (two with ADD)");
  static_assert(!ARING || (ANB >= 2 && 2 * NCONS * ANB * 8 <= ABAR_B), "the addend ring");
  static_assert(!UP2 || (TN == 128 && !ADD), "the phase form runs 128-channel tiles");
  // the epilogue's staging: 64 pixels x 64 channels a warpgroup (TRANS), or 16
  // pixels x TN channels a warp; rows padded by 16 bytes so that a store phase
  // hits every bank
  static constexpr int STG_ROW = (TRANS ? 64 : TN) * 2 + 16;
  static constexpr int STG_B = (TRANS ? 64 : TW) * STG_ROW;
  static_assert(COPY_B % 1024 == 0, "copies keep the swizzle's phase");
  static_assert((TRANS ? 1 : 4) * NCONS * STG_B <= HALO_B, "the staging fits in the copies");
};

// what a launch computes, beside the pointers and tensor maps
struct Geom {
  int H, W, C, Cout, OH, OW;  // UP2: H, W the low-resolution grid, Cout = 4 Fp
  int tiles_w, tiles_h, tiles_per_img, nco, ntiles, nch;
  int relu;
  int wtma;  // the weights come by TMA (TN >= 64, Cout % 8 == 0, w 16-byte aligned)
  int cvec;  // the output stores 16-byte vectors (Cout % 8 == 0, out 16-byte aligned)
  const float* add;  // ADD: the f32 addend [N / frames, OH, OW, Cout]
  int frames;        // ADD: output images per addend row
  int atma;          // ADD: the addend comes by TMA (amap; Cout % 4 == 0, add 16-byte aligned)
  int F, Fp;         // UP2: the output's channels, and each phase's in Cout
};

// chunk j (of 2) of pixel p of a halo copy is stored at chunk swz(p, j): the
// 32-byte swizzle, bit 4 of the offset XOR bit 7
__device__ __forceinline__ int swz(int p, int j) { return j ^ ((p >> 2) & 1); }

// byte offset of 16-byte chunk j (output channels 8j..8j+7) of weight row r:
// 64-channel atoms with the 128-byte swizzle; for TN = 8 one 16-byte row per k
template <int TN>
__device__ __forceinline__ int w_off(int r, int j) {
  if constexpr (TN >= 64) {
    return (j >> 3) * ATOM_B + r * 128 + ((j & 7) ^ (r & 7)) * 16;
  } else {
    return r * (TN * 2) + j * 16;
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the producer warpgroup's own barrier, the consumers', and each consumer
// warpgroup's (barrier 0 is __syncthreads')
template <int N = NPT>
__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 2, 256;\n" ::: "memory");
}

__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(3 + wg) : "memory");
}

// orders this thread's plain shared-memory stores before wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// waits for the phase of the given parity to complete; a wait of 10 s (a lost
// arrival) traps, a launch error, instead of hanging the stream
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  uint64_t t0, t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t0));
  while (!mbar_try_wait(bar, parity)) {
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
    if (t - t0 > 10000000000ull) __trap();
  }
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// shared-memory descriptor of the pixels (a halo copy): K-major with the
// 32-byte swizzle, a row the 32 bytes of k16, groups of 8 rows 256 bytes
// apart (SBO); the k extent lies inside one swizzle row, so LBO is unused
__device__ __forceinline__ uint64_t x_desc(uint32_t addr) {
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(256 >> 4) << 32) | (3ull << 62);
}

// shared-memory descriptor of the weights: MN-major. With the 128-byte
// swizzle (TN >= 64): LBO = the stride between 64-channel atoms, SBO = the
// stride between groups of 8 k-rows (1024 bytes). Without (TN = 8, one core
// matrix wide): the next 8 k-rows start 128 bytes on, and that is the only
// stride the k16 operand uses, so LBO and SBO both hold it.
template <int TN>
__device__ __forceinline__ uint64_t w_desc(uint32_t addr) {
  const uint64_t start = (addr & 0x3FFFF) >> 4;
  if constexpr (TN >= 64) {
    return start | ((uint64_t)(ATOM_B >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
  } else {
    return start | ((uint64_t)(128 >> 4) << 16) | ((uint64_t)(128 >> 4) << 32);
  }
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// D (m64 x n256, f32) += A (m64 x k16, MN-major) * B (k16 x n256, K-major), the
// transposed form: channels on M, pixels on N
__device__ __forceinline__ void wgmma_n256t(float (&d)[32][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
        "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
        "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
        "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
        "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
        "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]),
        "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
        "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]),
        "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
      : "l"(da), "l"(db), "r"(1));
}

// D (m64 x n8, f32) += A (m64 x k16, K-major) * B (k16 x n8, MN-major): the
// head's form, pixels on M
__device__ __forceinline__ void wgmma_n8(float (&d)[1][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3])
      : "l"(da), "l"(db), "r"(1));
}

// D (m64 x n16, f32) += A (m64 x k16, MN-major) * B (k16 x n16, K-major): UP2's
// row term over one row of a tile, into the registers that hold that row's 16
// pixels in the n256 accumulator (d0: pixels 0-7, d1: pixels 8-15)
__device__ __forceinline__ void wgmma_n16t(float (&d0)[4], float (&d1)[4], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d0[0]), "+f"(d0[1]), "+f"(d0[2]), "+f"(d0[3]), "+f"(d1[0]), "+f"(d1[1]),
        "+f"(d1[2]), "+f"(d1[3])
      : "l"(da), "l"(db), "r"(1));
}

// 16 bytes (k chunk j) of halo pixel (hy, hx), hx in 0..TW+1, into every copy
// from copy d0 on that holds it: copy dx keeps halo columns dx .. dx + TW - 1
__device__ __forceinline__ void put_halo(unsigned char* halo, int copy_b, int hy, int hx, int j,
                                         uint4 v, int d0 = 0) {
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
    const int c = hx - dx;
    if (dx >= d0 && c >= 0 && c < TW) {
      const int p = hy * TW + c;
      *reinterpret_cast<uint4*>(halo + dx * copy_b + p * PIX_B + swz(p, j) * 16) = v;
    }
  }
}

// eight bf16 values negated: their sign bits flipped, exact
__device__ __forceinline__ uint4 neg_bf16(uint4 v) {
  constexpr uint32_t m = 0x80008000u;
  return make_uint4(v.x ^ m, v.y ^ m, v.z ^ m, v.w ^ m);
}

// the n256 wgmmas of a stage, bit dy * 3 + dx a tap (#1 runs all nine; UP2
// leaves out the slots that hold its edge terms where they do not apply),
// and a mode: the taps, and in bits 9 + f UP2's row term
constexpr int TAPS_ALL = 0x1FF;
constexpr int TAPS_NO_F = 0x1B6;   // without column f = -1 (dx = 0)
constexpr int TAPS_NO_E = 0x1F8;   // without row e = -1 (dy = 0)
constexpr int TAPS_NO_EF = 0x1B0;  // without either
template <int V>
struct Mode {
  static constexpr int value = V;
};

// x: [N, H, W, C]; w: [3, 3, C, Cout]; out: [N, OH, OW, Cout], all bf16, with
// (OH, OW) = (H, W); UP2: w the phase weights [3, 3, C, Cout = 4 Fp], out
// [N, 2H, 2W, F]. VEC: x's rows are 16-byte vectors (C % 8 == 0, x aligned),
// so the halo copies come by TMA (xmap). wmap is read only when g.wtma, xmap
// only when VEC. ADD: the epilogue adds g.add's f32 value at each output
// element of the sample (amap: its tensor map, read when g.atma and TN >= 64).
// The body of the two kernels below, which name the two ops' launches apart.
template <int TN, bool UP2, bool VEC, bool ADD>
__device__ __forceinline__ void conv3x3_mma_body(const CUtensorMap& xmap, const CUtensorMap& wmap,
                                                 const CUtensorMap& amap,
                                                 const __nv_bfloat16* __restrict__ x,
                                                 const __nv_bfloat16* __restrict__ w,
                                                 const float* __restrict__ scale,
                                                 const float* __restrict__ shift,
                                                 __nv_bfloat16* __restrict__ out, const Geom g) {
  static_assert(TN == 128 || TN == 64 || TN == 8, "tile width");
  static_assert(!(ADD && UP2), "the addend has no upsampled form");
  using S = Tile<TN, UP2, ADD>;
  constexpr int MT = S::MT, TH = S::TH, NS = S::STAGES, NT = TN / 8;
  extern __shared__ __align__(128) unsigned char mma_smem[];
  unsigned char* smem = mma_smem + ((1024 - (smem_u32(mma_smem) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t ring_base = sbase + NS * S::STAGE_B;  // ADD: the addend rings
  const uint32_t abars = ring_base + S::ANB * NCONS * S::AROW_B;
  const uint32_t col_base = ring_base + S::ADD_B;  // UP2: the stages' column copies
  const uint32_t bars = col_base + NS * S::COL_B;
  // the producer threads that arrive on a stage's full barrier: all; ADD: all
  // but the last warp, which fetches the addend; UP2: all but the first, which
  // issues the TMA
  constexpr int NPS = S::ARING || UP2 ? NPT - 32 : NPT;
  // full: the stage's TMA bytes and an arrival from every stage producer
  // thread (UP2: and from the thread that issues the TMA, with the weights'
  // bytes); empty: one arrival per consumer warp
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (NS + s); };
  auto loaded = [&](int s) { return bars + 8 * (2 * NS + s); };  // UP2: the stage's copies' TMA
  // ADD: consumer warpgroup w's addend buffer s and its barriers: afull (the
  // TMA bytes, or the fetching warp's one arrival), aempty (one arrival per
  // consumer warp of w)
  auto abuf = [&](int w, int s) { return ring_base + (w * S::ANB + s) * S::AROW_B; };
  auto afull = [&](int w, int s) { return abars + 8 * (w * S::ANB + s); };
  auto aempty = [&](int w, int s) { return abars + 8 * ((NCONS + w) * S::ANB + s); };
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full(s), NPS + UP2);
      mbar_init(empty(s), 4 * NCONS);
      if constexpr (UP2) mbar_init(loaded(s), 1);
    }
    for (int w = 0; w < NCONS; ++w)
      for (int s = 0; s < S::ANB; ++s) {
        mbar_init(afull(w, s), 1);
        mbar_init(aempty(w, s), 4);
      }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int n_mine = (g.ntiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int items = n_mine * g.nch;  // (tile, chunk) pairs of this block, in ring order
  struct Item {
    int n, oy0, ox0, co0, c0;
  };
  // UP2: tiles of the low-resolution grid aligned to its bottom and right
  // edges, so the first may start above or left of the image
  auto item = [&](int i) {
    const int t = (int)blockIdx.x + (i / g.nch) * (int)gridDim.x;
    const int rest = t / g.nco;
    const int tile = rest % g.tiles_per_img;
    const int ty = tile / g.tiles_w, tx = tile % g.tiles_w;
    return Item{rest / g.tiles_per_img, UP2 ? g.H - (g.tiles_h - ty) * TH : ty * TH,
                UP2 ? g.W - (g.tiles_w - tx) * TW : tx * TW, (t - rest * g.nco) * TN,
                (i % g.nch) * CK};
  };
  // UP2: the phase b of a tile's 128 channels (one b a tile, Fp a multiple of 64)
  auto phase_b = [&](const Item& it) { return UP2 ? (it.co0 / g.Fp) >> 1 : 0; };
  // UP2: the taps whose weights atom g of a tile reads: phase b = 1 away from
  // the right edge reads no column f = -1 (its column copy would be 0), phase
  // a = 1 no row e = -1 but on the bottom edge, where its row term reads it
  auto up2_taps = [&](const Item& it, int g_atom) {
    const int q = (it.co0 + 64 * g_atom) / g.Fp;
    const bool no_f = (q >> 1) && it.ox0 + TW < g.W;
    const bool all_e = !(q & 1) || it.oy0 + TH >= g.H;
    return all_e ? (no_f ? TAPS_NO_F : TAPS_ALL) : (no_f ? TAPS_NO_EF : TAPS_NO_E);
  };

  if (threadIdx.x < NPT) {
    // ------------------------------------------------------------ producer
    const int ptid = threadIdx.x;
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    // C % 8 != 0: item it's halo element by element into the copies from d0
    // on, 0 outside the image and past C, by threads t, t + nt, ...
    auto load_halo = [&](const Item& it, unsigned char* halo, int t, int nt, int d0) {
      const __nv_bfloat16* xn = x + (size_t)it.n * g.H * g.W * g.C;
      for (int k = t; k < (TH + 2) * HW * 2; k += nt) {
        const int p = k >> 1, j = k & 1;
        const int hy = p / HW, hx = p % HW;
        const int gy = it.oy0 - 1 + hy, gx = it.ox0 - 1 + hx;
        uint4 v;
        __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
        for (int ci = 0; ci < 8; ++ci) {
          const int c = it.c0 + j * 8 + ci;
          const bool ok = c < g.C && gy >= 0 && gy < g.H && gx >= 0 && gx < g.W;
          e[ci] = ok ? xn[((size_t)gy * g.W + gx) * g.C + c] : zero;
        }
        put_halo(halo, S::COPY_B, hy, hx, j, v, d0);
      }
    };
    if constexpr (S::ARING) {
      if (ptid >= NPS) {
        // the addend: for each tile of the block, output row q of consumer
        // warpgroup w's 256 pixels (channels 64 w.. for TN = 128, rows 16 w..
        // for TN = 64) into w's ring, row R = 16 t + q in buffer R % ANB
        const int lane = ptid & 31;
        for (int t = 0; t < n_mine; ++t) {
          const Item tl = item(t * g.nch);
          const int ns = tl.n / g.frames;
          for (int q = 0; q < 16; ++q) {
            const int R = 16 * t + q, s = R % S::ANB;
            for (int w = 0; w < NCONS; ++w) {
              const int oy = tl.oy0 + (TN == 128 ? 0 : 16 * w) + q;
              const int oa = tl.co0 + (TN == 128 ? 64 * w : 0);
              mbar_wait(aempty(w, s), ((R / S::ANB) & 1) ^ 1);
              if (g.atma) {
                if (lane == 0) {
                  mbar_arrive_tx(afull(w, s), S::AROW_B);
                  tma_load_4d(abuf(w, s), &amap, afull(w, s), oa, tl.ox0, oy, ns);
                  tma_load_4d(abuf(w, s) + S::AROW_B / 2, &amap, afull(w, s), oa + 32, tl.ox0, oy,
                              ns);
                }
              } else {
                // element by element, zero outside the image and past Cout
                unsigned char* b = smem + (abuf(w, s) - sbase);
                const float* img = g.add + (size_t)ns * g.OH * g.OW * g.Cout;
                for (int k = lane; k < TW * 64; k += 32) {
                  const int px = k >> 6, ch = k & 63;
                  const int ox = tl.ox0 + px, o = oa + ch;
                  const float v = oy < g.OH && ox < g.OW && o < g.Cout
                                      ? img[((size_t)oy * g.OW + ox) * g.Cout + o]
                                      : 0.f;
                  *reinterpret_cast<float*>(b + (ch >> 5) * (S::AROW_B / 2) + px * 128 +
                                            ((((ch & 31) >> 2) ^ (px & 7)) << 4) + (ch & 3) * 4) = v;
                }
                __syncwarp();
                if (lane == 0) mbar_arrive(afull(w, s));
              }
            }
          }
        }
        return;
      }
    }
    if constexpr (UP2) {
      // the column copies are 0 but in their last column, the only one written
      for (int k = ptid; k < NS * S::COL_B / 16; k += NPT)
        reinterpret_cast<uint4*>(smem + (col_base - sbase))[k] = make_uint4(0u, 0u, 0u, 0u);
      producer_sync();
      if (ptid < 32) {
        // the first warp: each item's weights by TMA into full, and (VEC) its
        // copies into loaded, as soon as the stage is free; b = 1 tiles load
        // no copy 0
        for (int i = 0; i < items; ++i) {
          const Item it = item(i);
          const int s = i % NS;
          mbar_wait(empty(s), ((i / NS) & 1) ^ 1);
          if (ptid == 0) {
            const uint32_t st = sbase + s * S::STAGE_B;
            // the taps that the atom's warpgroup runs, one TMA box a tap
            const int m0 = up2_taps(it, 0), m1 = up2_taps(it, 1);
            mbar_arrive_tx(full(s), (__popc(m0) + __popc(m1)) * CK * 128);
            for (int tap = 0; tap < 9; ++tap) {
              if ((m0 >> tap) & 1)
                tma_load_3d(st + tap * CK * 128, &wmap, full(s), it.co0, it.c0, tap);
              if ((m1 >> tap) & 1)
                tma_load_3d(st + ATOM_B + tap * CK * 128, &wmap, full(s), it.co0 + 64, it.c0, tap);
            }
            if constexpr (VEC) {
              const int d0 = phase_b(it);
              mbar_arrive_tx(loaded(s), (3 - d0) * S::COPY_B);
              for (int dx = d0; dx < 3; ++dx)
                tma_load_4d(st + S::HALO_OFF + dx * S::COPY_B, &xmap, loaded(s), it.c0,
                            it.ox0 - 1 + dx, it.oy0 - 1, it.n);
            }
          }
        }
        return;
      }
      // the other NPS threads: each item's copies (VEC: once their TMA has
      // landed; else element by element) with x padded by -x[0] before and
      // +x[n-1] after on each axis, the pad lines of the edge tiles patched,
      // then (b = 1 on the right edge) the column copy: halo column TW, x[:,
      // W-1], into the copy's last column
      const int pt = ptid - 32;
      for (int i = 0; i < items; ++i) {
        const Item it = item(i);
        const int s = i % NS;
        unsigned char* halo = smem + s * S::STAGE_B + S::HALO_OFF;
        unsigned char* col = smem + (col_base - sbase) + s * S::COL_B;
        const int d0 = phase_b(it);
        if constexpr (VEC) {
          mbar_wait(loaded(s), (i / NS) & 1);
        } else {
          mbar_wait(empty(s), ((i / NS) & 1) ^ 1);
          load_halo(it, halo, pt, NPS, d0);
          producer_sync<NPS>();
        }
        // 16 bytes of halo pixel (hy, hx) from a copy that holds it
        auto get = [&](int hy, int hx, int j) {
          const int dx = hx >= TW ? hx - TW + 1 : d0;
          const int p = hy * TW + hx - dx;
          return *reinterpret_cast<const uint4*>(halo + dx * S::COPY_B + p * PIX_B +
                                                 swz(p, j) * 16);
        };
        const bool top = it.oy0 <= 0, left = it.ox0 <= 0;
        const bool bottom = it.oy0 + TH >= g.H, right = it.ox0 + TW >= g.W;
        // the columns first, so that the pad rows carry the corners' products
        if (left || right) {
          for (int k = pt; k < (TH + 2) * 2; k += NPS) {
            const int hy = k >> 1, j = k & 1;
            if (left && (it.ox0 < 0 || !d0))  // halo column 0 is in copy 0 alone
              put_halo(halo, S::COPY_B, hy, -it.ox0, j, neg_bf16(get(hy, 1 - it.ox0, j)), d0);
            if (right) put_halo(halo, S::COPY_B, hy, TW + 1, j, get(hy, TW, j), d0);
          }
          producer_sync<NPS>();
        }
        if (top || bottom) {
          for (int k = pt; k < HW * 2; k += NPS) {
            const int hx = k >> 1, j = k & 1;
            if (hx < d0) continue;
            if (top)
              put_halo(halo, S::COPY_B, -it.oy0, hx, j, neg_bf16(get(1 - it.oy0, hx, j)), d0);
            if (bottom) put_halo(halo, S::COPY_B, TH + 1, hx, j, get(TH, hx, j), d0);
          }
          producer_sync<NPS>();
        }
        if (d0 && right) {
          for (int k = pt; k < (TH + 2) * 2; k += NPS) {
            const int hy = k >> 1, j = k & 1, p = hy * TW + TW - 1;
            *reinterpret_cast<uint4*>(col + p * PIX_B + swz(p, j) * 16) = get(hy, TW, j);
          }
        }
        fence_proxy_async();  // the plain stores above, before the consumers' wgmmas
        mbar_arrive(full(s));
      }
      return;
    }
    // thread 0: the stage's TMA loads, after announcing their bytes
    auto tma_stage = [&](const Item& it, int s) {
      const uint32_t st = sbase + s * S::STAGE_B;
      if (g.wtma) {
#pragma unroll
        for (int a = 0; a < TN / 64; ++a)
          tma_load_3d(st + a * ATOM_B, &wmap, full(s), it.co0 + 64 * a, it.c0, 0);
      }
      if constexpr (VEC) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          tma_load_4d(st + S::HALO_OFF + dx * S::COPY_B, &xmap, full(s), it.c0, it.ox0 - 1 + dx,
                      it.oy0 - 1, it.n);
      }
    };
    const uint32_t tx = (g.wtma ? S::W_B : 0) + (VEC ? S::HALO_B : 0);
    for (int i = 0; i < items; ++i) {
      const Item it = item(i);
      const int s = i % NS;
      const uint32_t par = (i / NS) & 1;
      unsigned char* st_p = smem + s * S::STAGE_B;
      unsigned char* halo = st_p + S::HALO_OFF;
      mbar_wait(empty(s), par ^ 1);
      if (ptid == 0 && tx) {
        mbar_expect_tx(full(s), tx);
        tma_stage(it, s);
      }
      // element-wise weights (TN = 8, or Cout % 8 != 0), written only when the
      // stage held other ones: the head's 4 chunks fill its 4 stages once
      if (!g.wtma && !(i >= NS && item(i - NS).c0 == it.c0 && item(i - NS).co0 == it.co0)) {
        // weight rows r = tap * CK + ci, zero past C and Cout
        for (int k = ptid; k < 9 * CK * TN; k += NPS) {
          const int r = k / TN, co = k % TN;
          const int tap = r / CK, c = it.c0 + r % CK, o = it.co0 + co;
          *reinterpret_cast<__nv_bfloat16*>(st_p + w_off<TN>(r, co >> 3) + (co & 7) * 2) =
              (c < g.C && o < g.Cout) ? w[((size_t)tap * g.C + c) * g.Cout + o] : zero;
        }
      }
      if constexpr (!VEC) load_halo(it, halo, ptid, NPS, 0);
      fence_proxy_async();  // the plain stores above, before the consumers' wgmmas
      mbar_arrive(full(s));
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  const int cw = (threadIdx.x >> 5) - 4;  // consumer warp 0..7; warp cw & 3 of its warpgroup
  const int wg = cw >> 2;
  const int lane = threadIdx.x & 31;
  // TRANS: the warpgroup's atom (64 channels) and first output row of its 256
  // pixels; the head: its first output row
  const int atom = TN == 128 ? wg : 0;
  const int row0 = TN == 128 ? 0 : wg * (TH / NCONS);
  constexpr int AM = S::TRANS ? 1 : MT, AN = S::TRANS ? 32 : NT;
  const int wtid = threadIdx.x & 127;
  float acc[AM][AN][4];
  int i = 0;  // the item of the ring, as the producer counts them
  for (int t = 0; t < n_mine; ++t) {
    const Item tile = item(i);
#pragma unroll
    for (int m = 0; m < AM; ++m)
#pragma unroll
      for (int n = 0; n < AN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
    // UP2: the warpgroup's phase (pa, pb); b = 1 tiles on the right edge read
    // the column copy for copy 0
    const int q = UP2 ? (tile.co0 + 64 * atom) / g.Fp : 0;
    const int pa = q & 1, pb = q >> 1;
    const bool colcopy = UP2 && pb && tile.ox0 + TW >= g.W;
    // the tile's stages, with the taps and the row term of a mode
    auto stages = [&](auto mode) {
      constexpr int TAPS = decltype(mode)::value & 0x1FF, ROWS = decltype(mode)::value >> 9;
      for (int ch = 0; ch < g.nch; ++ch, ++i) {
        const int s = i % NS;
        mbar_wait(full(s), (i / NS) & 1);
        const uint32_t wsm = sbase + s * S::STAGE_B, halo = wsm + S::HALO_OFF;
        const uint32_t copy0 = colcopy ? col_base + s * S::COL_B : halo;
        wgmma_fence();
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          if (!((TAPS >> tap) & 1)) continue;
          const int dy = tap / 3, dx = tap % 3;
          const uint64_t dw = w_desc<TN>(wsm + atom * ATOM_B + w_off<TN>(tap * CK, 0));
          const uint32_t cp = dx ? halo + dx * S::COPY_B : copy0;
          // the pixels of output rows y.. are copy dx from row y + dy
          if constexpr (S::TRANS) {
            wgmma_n256t(acc[0], dw, x_desc(cp + (row0 + dy) * TW * PIX_B));
          } else {
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              wgmma_n8(acc[mt], x_desc(cp + (row0 + 4 * mt + dy) * TW * PIX_B), dw);
          }
        }
        if constexpr (ROWS != 0) {
          // the tile's last row (halo row TH) through the slots e = -1: pixels
          // 16 (TH - 1).. of the accumulator
#pragma unroll
          for (int f = 0; f < 3; ++f) {
            if (!((ROWS >> f) & 1)) continue;
            wgmma_n16t(acc[0][2 * TH - 2], acc[0][2 * TH - 1],
                       w_desc<TN>(wsm + atom * ATOM_B + w_off<TN>(f * CK, 0)),
                       x_desc((f ? halo + f * S::COPY_B : copy0) + TH * TW * PIX_B));
          }
        }
        wgmma_commit();
        wgmma_wait<1>();
        // every wgmma of the previous stage is done: release it
        if (ch > 0 && lane == 0) mbar_arrive(empty((i - 1) % NS));
      }
    };
    if constexpr (UP2) {
      // b = 1 away from the right edge: no column f = -1; a = 1: no row e =
      // -1, and on the bottom edge the row term
      const bool no_f = pb && !colcopy;
      if (!pa) {
        if (no_f) stages(Mode<TAPS_NO_F>{});
        else stages(Mode<TAPS_ALL>{});
      } else if (tile.oy0 + TH < g.H) {
        if (no_f) stages(Mode<TAPS_NO_EF>{});
        else stages(Mode<TAPS_NO_E>{});
      } else {
        if (no_f) stages(Mode<TAPS_NO_EF | 6 << 9>{});
        else stages(Mode<TAPS_NO_E | 7 << 9>{});
      }
    } else {
      stages(Mode<TAPS_ALL>{});
    }
    wgmma_wait<0>();
    // keep the compiler from reading the accumulators above the last wgmma wait
#pragma unroll
    for (int m = 0; m < AM; ++m)
#pragma unroll
      for (int n = 0; n < AN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(acc[m][n][e])::"memory");

    // epilogue: affine + ReLU in registers, one rounding, staged in the halo
    // copies of the tile's last stage (every consumer warp is done reading
    // them) so that each output row goes out in 16-byte vectors; the stage is
    // released after
    consumer_sync();
    const int last = (i - 1) % NS;
    if constexpr (S::TRANS) {
      // d[j][2h + e]: channel 16 (cw & 3) + lane / 4 + 8h of the atom, pixel
      // 8j + 2 (lane % 4) + e of the warpgroup's 256; staged 64 pixels (4
      // output rows) at a time, [pixel][64 channels]. UP2: the atom's channels
      // are output channels ob.. of phase (pa, pb), its pixel (i, j) output
      // pixel (2i + pa, 2j + pb)
      unsigned char* stg = smem + last * S::STAGE_B + S::HALO_OFF + wg * S::STG_B;
      const int cl = 16 * (cw & 3) + (lane >> 2);  // the thread's channel (h = 0) in the atom
      const int oa = tile.co0 + 64 * atom;
      const int ob = UP2 ? oa - q * g.Fp : oa, cmax = UP2 ? g.F : g.Cout;
      float sc[2], sh[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = ob + cl + 8 * h;
        sc[h] = o < cmax ? scale[o] : 0.f;
        sh[h] = o < cmax ? shift[o] : 0.f;
      }
      // the output pixel of staged pixel px of row group r, and whether it is
      // in the image
      auto out_px = [&](int oyr, int px, int& oy, int& ox) {
        oy = oyr + px / TW;
        ox = tile.ox0 + px % TW;
        if constexpr (UP2) {
          const bool in = oy >= 0 && oy < g.H && ox >= 0 && ox < g.W;
          oy = 2 * oy + pa;
          ox = 2 * ox + pb;
          return in;
        } else {
          return oy < g.OH && ox < g.OW;
        }
      };
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int oyr = tile.oy0 + row0 + 4 * r;
        // ADD: the addend buffer of output row 4 r + jj / 2 of the warpgroup's
        [[maybe_unused]] int slot = 0;
        [[maybe_unused]] const unsigned char* arow = nullptr;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          if constexpr (ADD) {
            if (jj % 2 == 0) {
              const int R = 16 * t + 4 * r + jj / 2;
              slot = R % S::ANB;
              mbar_wait(afull(wg, slot), (R / S::ANB) & 1);
              arow = smem + (abuf(wg, slot) - sbase);
            }
          }
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int px = 8 * jj + 2 * (lane & 3) + e;
              float a = acc[0][8 * r + jj][2 * h + e];
              if constexpr (ADD) {
                const int p = px % TW, ch = cl + 8 * h;
                a += *reinterpret_cast<const float*>(arow + (ch >> 5) * (S::AROW_B / 2) + p * 128 +
                                                     ((((ch & 31) >> 2) ^ (p & 7)) << 4) +
                                                     (ch & 3) * 4);
              }
              float y = a * sc[h] + sh[h];
              if (g.relu) y = fmaxf(y, 0.f);
              *reinterpret_cast<__nv_bfloat16*>(stg + px * S::STG_ROW + (cl + 8 * h) * 2) =
                  __float2bfloat16(y);
            }
          if constexpr (ADD) {
            if (jj % 2 == 1) {  // the warp is done with the row's buffer
              __syncwarp();
              if (lane == 0) mbar_arrive(aempty(wg, slot));
            }
          }
        }
        warpgroup_sync(wg);
        if (g.cvec) {
          for (int k = wtid; k < 64 * 8; k += 128) {
            const int px = k >> 3, c = k & 7, o = ob + c * 8;
            int oy, ox;
            if (out_px(oyr, px, oy, ox) && o < cmax)
              *reinterpret_cast<uint4*>(out + (((size_t)tile.n * g.OH + oy) * g.OW + ox) * cmax +
                                        o) =
                  *reinterpret_cast<const uint4*>(stg + px * S::STG_ROW + c * 16);
          }
        } else {
          for (int k = wtid; k < 64 * 64; k += 128) {
            const int px = k >> 6, c = k & 63, o = ob + c;
            int oy, ox;
            if (out_px(oyr, px, oy, ox) && o < cmax)
              out[(((size_t)tile.n * g.OH + oy) * g.OW + ox) * cmax + o] =
                  *reinterpret_cast<const __nv_bfloat16*>(stg + px * S::STG_ROW + c * 2);
          }
        }
        warpgroup_sync(wg);
      }
    } else {
      // d[mt][0][2h + e]: pixel lane / 4 + 8h of output row 4 mt + (cw & 3) of
      // the warpgroup's, channel 2 (lane % 4) + e; staged [16 pixels][TN] a warp
      unsigned char* stg = smem + last * S::STAGE_B + S::HALO_OFF + cw * S::STG_B;
      const int o = tile.co0 + (lane & 3) * 2;
      const float s0 = o < g.Cout ? scale[o] : 0.f, t0 = o < g.Cout ? shift[o] : 0.f;
      const float s1 = o + 1 < g.Cout ? scale[o + 1] : 0.f;
      const float t1 = o + 1 < g.Cout ? shift[o + 1] : 0.f;
      // ADD: at most 8 channels a pixel, read straight from the addend (its
      // registers fit beside the head's 4 x MT accumulators)
      const float* addn = ADD ? g.add + (size_t)(tile.n / g.frames) * g.OH * g.OW * g.Cout : nullptr;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int oy = tile.oy0 + row0 + 4 * mt + (cw & 3);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float a0 = acc[mt][0][2 * h], a1 = acc[mt][0][2 * h + 1];
          if constexpr (ADD) {
            const int ox = tile.ox0 + (lane >> 2) + 8 * h;
            if (oy < g.OH && ox < g.OW) {
              const float* ap = addn + ((size_t)oy * g.OW + ox) * g.Cout;
              if (o < g.Cout) a0 += __ldg(ap + o);
              if (o + 1 < g.Cout) a1 += __ldg(ap + o + 1);
            }
          }
          float y0 = a0 * s0 + t0;
          float y1 = a1 * s1 + t1;
          if (g.relu) {
            y0 = fmaxf(y0, 0.f);
            y1 = fmaxf(y1, 0.f);
          }
          *reinterpret_cast<__nv_bfloat162*>(stg + ((lane >> 2) + 8 * h) * S::STG_ROW +
                                             (lane & 3) * 4) = __floats2bfloat162_rn(y0, y1);
        }
        __syncwarp();
        for (int k = lane; k < TW * TN; k += 32) {
          const int px = k / TN, c = k % TN;
          const int ox = tile.ox0 + px, oc = tile.co0 + c;
          if (oy < g.OH && ox < g.OW && oc < g.Cout)
            out[(((size_t)tile.n * g.OH + oy) * g.OW + ox) * g.Cout + oc] =
                *reinterpret_cast<const __nv_bfloat16*>(stg + px * S::STG_ROW + c * 2);
        }
        __syncwarp();
      }
    }
    fence_proxy_async();  // the staging stores, before the producer's next TMA writes here
    if (lane == 0) mbar_arrive(empty(last));
  }
}

// #1 and #2
template <int TN, bool UP2, bool VEC>
__global__ void __launch_bounds__(NTHREADS, 1)
conv3x3_bf16_mma_kernel(const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap wmap,
                        const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                        const float* __restrict__ scale, const float* __restrict__ shift,
                        __nv_bfloat16* __restrict__ out, const Geom g) {
  conv3x3_mma_body<TN, UP2, VEC, false>(xmap, wmap, xmap, x, w, scale, shift, out, g);
}

// #2's phase weights kp [3][3][C][4 Fp] from its kernel k [3][3][C][F], in f32
// from k's bf16 values, rounded once. Channel o' = (2b + a) Fp + o is output
// channel o of phase (a, b), 0 for o >= F. Tap (e, f) of the low-resolution x
// (e, f in -1..1, index e + 1, f + 1) holds K_ab[e][f] = sum_{dy,dx}
// A_a[e][dy] A_b[f][dx] k[dy][dx], with A_0 = ((.5, 0, 0), (.5, 1, .5), (0, 0,
// .5)) and A_1 = ((0, 0, 0), (1, .5, 0), (0, .5, 1)) (rows e, columns dy: the
// reference's _A0, _A1), except the slots where K_ab is 0, which hold the
// edge terms (the header): a = 1, e = -1: -sum_dx A_b[f][dx] k[+1][dx]; b = 1,
// f = -1: -sum_dy A_a[e][dy] k[dy][+1]; phase (1, 1) at (-1, -1): +k[+1][+1].
// One thread an input channel and output channel o' for the nine taps.
__global__ void up2_phase_weights_kernel(const __nv_bfloat16* __restrict__ k,
                                         __nv_bfloat16* __restrict__ kp, int C, int F, int Fp) {
  const int n4 = 4 * Fp;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= C * n4) return;
  const int c = idx / n4, op = idx % n4;
  const int q = op / Fp, o = op % Fp, a = q & 1, b = q >> 1;
  constexpr float A0[3][3] = {{.5f, 0.f, 0.f}, {.5f, 1.f, .5f}, {0.f, 0.f, .5f}};
  constexpr float A1[3][3] = {{0.f, 0.f, 0.f}, {1.f, .5f, 0.f}, {0.f, .5f, 1.f}};
  float kk[3][3], Aa[3][3], Ab[3][3];
#pragma unroll
  for (int u = 0; u < 3; ++u)
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      kk[u][v] = o < F ? __bfloat162float(k[((size_t)(u * 3 + v) * C + c) * F + o]) : 0.f;
      Aa[u][v] = a ? A1[u][v] : A0[u][v];
      Ab[u][v] = b ? A1[u][v] : A0[u][v];
    }
  float t[3][3], K[3][3];  // t[e][dx] = sum_dy A_a[e][dy] k[dy][dx]
#pragma unroll
  for (int e = 0; e < 3; ++e)
#pragma unroll
    for (int d = 0; d < 3; ++d) t[e][d] = Aa[e][0] * kk[0][d] + Aa[e][1] * kk[1][d] + Aa[e][2] * kk[2][d];
#pragma unroll
  for (int e = 0; e < 3; ++e)
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      K[e][f] = Ab[f][0] * t[e][0] + Ab[f][1] * t[e][1] + Ab[f][2] * t[e][2];
      if (a && e == 0) K[e][f] = -(Ab[f][0] * kk[2][0] + Ab[f][1] * kk[2][1] + Ab[f][2] * kk[2][2]);
      if (b && f == 0) K[e][f] = -(Aa[e][0] * kk[0][2] + Aa[e][1] * kk[1][2] + Aa[e][2] * kk[2][2]);
      if (a && b && e == 0 && f == 0) K[e][f] = kk[2][2];
      kp[((size_t)(e * 3 + f) * C + c) * n4 + op] = __float2bfloat16(K[e][f]);
    }
}

// #1+: #1 with the addend
template <int TN, bool VEC>
__global__ void __launch_bounds__(NTHREADS, 1)
conv3x3_add_bf16_mma_kernel(const __grid_constant__ CUtensorMap xmap,
                            const __grid_constant__ CUtensorMap wmap,
                            const __grid_constant__ CUtensorMap amap,
                            const __nv_bfloat16* __restrict__ x,
                            const __nv_bfloat16* __restrict__ w, const float* __restrict__ scale,
                            const float* __restrict__ shift, __nv_bfloat16* __restrict__ out,
                            const Geom g) {
  conv3x3_mma_body<TN, false, VEC, true>(xmap, wmap, amap, x, w, scale, shift, out, g);
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no link to libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
#endif
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// a bf16 (or f32) tensor map with 16-byte-aligned rows; dims and box
// innermost first
template <int R>
inline cudaError_t tensor_map(CUtensorMap* map, const void* base, const cuuint64_t (&dims)[R],
                              const cuuint32_t (&box)[R], CUtensorMapSwizzle swizzle,
                              bool f32 = false) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  cuuint64_t strides[R - 1];
  cuuint64_t s = dims[0] * (f32 ? 4 : 2);
  for (int d = 0; d < R - 1; ++d) {
    strides[d] = s;
    s *= dims[d + 1];
  }
  cuuint32_t ones[R];
  for (int d = 0; d < R; ++d) ones[d] = 1;
  const CUresult r = encode(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                            R, const_cast<void*>(base),
                            dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return n;
}

template <int TN, bool UP2, bool VEC, bool ADD>
cudaError_t launch_mma(const __nv_bfloat16* x, const __nv_bfloat16* w, __nv_bfloat16* work,
                       const float* add, int frames, const float* scale, const float* shift,
                       __nv_bfloat16* out, int N, int H, int W, int C, int Cout, int relu,
                       bool wvec, bool cvec, cudaStream_t stream) {
  using S = Tile<TN, UP2, ADD>;
  auto kern = conv3x3_bf16_mma_kernel<TN, UP2, VEC>;
  auto add_kern = conv3x3_add_bf16_mma_kernel<TN, VEC>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = ADD ? cudaFuncSetAttribute(add_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               S::BYTES)
                        : cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               S::BYTES);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  Geom g;
  g.H = H, g.W = W, g.C = C, g.Cout = Cout;
  g.F = Cout, g.Fp = (Cout + 63) / 64 * 64;
  g.OH = UP2 ? 2 * H : H, g.OW = UP2 ? 2 * W : W;
  if (UP2) {
    // the phase weights, into work, launched before the conv on the same stream
    g.Cout = 4 * g.Fp;
    const int n = C * g.Cout;
    if (n > 0) {
      up2_phase_weights_kernel<<<(n + 255) / 256, 256, 0, stream>>>(w, work, C, Cout, g.Fp);
      cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
    w = work;
  }
  g.tiles_w = (W + TW - 1) / TW;
  g.tiles_h = (H + S::TH - 1) / S::TH;
  g.tiles_per_img = g.tiles_h * g.tiles_w;
  g.nco = (g.Cout + TN - 1) / TN;
  g.ntiles = N * g.tiles_per_img * g.nco;
  g.nch = (C + CK - 1) / CK;
  g.relu = relu;
  g.wtma = TN >= 64 && (UP2 || wvec);
  g.cvec = cvec;
  g.add = add;
  g.frames = frames;
  g.atma = Cout % 4 == 0 && (reinterpret_cast<uintptr_t>(add) & 15) == 0;
  if (g.ntiles == 0) return cudaSuccess;
  CUtensorMap xmap, wmap, amap;
  memset(&xmap, 0, sizeof(xmap));
  memset(&wmap, 0, sizeof(wmap));
  memset(&amap, 0, sizeof(amap));
  if (VEC) {
    // the halo copies (32-byte swizzle)
    cudaError_t e =
        tensor_map<4>(&xmap, x, {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N},
                      {CK, TW, S::TH + 2, 1}, CU_TENSOR_MAP_SWIZZLE_32B);
    if (e != cudaSuccess) return e;
  }
  if (g.wtma) {
    // a box of 64 channels x CK rows: all nine taps, or (UP2) one
    cudaError_t e = tensor_map<3>(&wmap, w, {(cuuint64_t)g.Cout, (cuuint64_t)C, 9},
                                  {64, CK, UP2 ? 1u : 9u}, CU_TENSOR_MAP_SWIZZLE_128B);
    if (e != cudaSuccess) return e;
  }
  if (S::ARING && g.atma) {
    // the addend's rows, two boxes of 32 channels x 16 pixels a ring buffer
    cudaError_t e = tensor_map<4>(
        &amap, add, {(cuuint64_t)Cout, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)(N / frames)},
        {32, TW, 1, 1}, CU_TENSOR_MAP_SWIZZLE_128B, true);
    if (e != cudaSuccess) return e;
  }
  const int sms = sm_count();
  const int grid = g.ntiles < sms ? g.ntiles : sms;
  if (ADD)
    add_kern<<<grid, NTHREADS, S::BYTES, stream>>>(xmap, wmap, amap, x, w, scale, shift, out, g);
  else
    kern<<<grid, NTHREADS, S::BYTES, stream>>>(xmap, wmap, x, w, scale, shift, out, g);
  return cudaGetLastError();
}

template <bool VEC, bool ADD>
cudaError_t dispatch_mma(const __nv_bfloat16* x, const __nv_bfloat16* w, const float* add,
                         int frames, const float* scale, const float* shift, __nv_bfloat16* out,
                         int N, int H, int W, int C, int Cout, int relu, bool wvec, bool cvec,
                         cudaStream_t stream) {
  // 128 output channels a tile for the wide layers, 64 for C' = 64 (a
  // 128-wide tile would idle half its lanes), 8 for the 4-channel head
  if (Cout >= 128)
    return launch_mma<128, false, VEC, ADD>(x, w, nullptr, add, frames, scale, shift, out, N, H,
                                            W, C, Cout, relu, wvec, cvec, stream);
  if (Cout > 8)
    return launch_mma<64, false, VEC, ADD>(x, w, nullptr, add, frames, scale, shift, out, N, H, W,
                                           C, Cout, relu, wvec, cvec, stream);
  return launch_mma<8, false, VEC, ADD>(x, w, nullptr, add, frames, scale, shift, out, N, H, W, C,
                                        Cout, relu, wvec, cvec, stream);
}

inline bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// add: null for #1 / #2; for #1+ the f32 addend [N / frames, H, W, Cout].
// work (up2): room for the phase weights, [3, 3, C, 4 Fp] bf16 (Fp: Cout
// rounded up to 64), 16-byte aligned
inline cudaError_t conv3x3_bf16(int up2, const void* x, const void* w, void* work,
                                const float* add, int frames, const float* scale,
                                const float* shift, void* out, int N, int H, int W, int C,
                                int Cout, int relu, cudaStream_t stream) {
  auto xb = static_cast<const __nv_bfloat16*>(x);
  auto wb = static_cast<const __nv_bfloat16*>(w);
  auto ob = static_cast<__nv_bfloat16*>(out);
  const bool vec = C % 8 == 0 && aligned(x, 16);
  const bool wvec = Cout % 8 == 0 && aligned(w, 16);
  const bool cvec = Cout % 8 == 0 && aligned(out, 16);
  if (up2) {
    if (!work || !aligned(work, 16)) return cudaErrorInvalidValue;
    auto kb = static_cast<__nv_bfloat16*>(work);
    return vec ? launch_mma<128, true, true, false>(xb, wb, kb, nullptr, 0, scale, shift, ob, N,
                                                    H, W, C, Cout, relu, wvec, cvec, stream)
               : launch_mma<128, true, false, false>(xb, wb, kb, nullptr, 0, scale, shift, ob, N,
                                                     H, W, C, Cout, relu, wvec, cvec, stream);
  }
  if (add)
    return vec ? dispatch_mma<true, true>(xb, wb, add, frames, scale, shift, ob, N, H, W, C, Cout,
                                          relu, wvec, cvec, stream)
               : dispatch_mma<false, true>(xb, wb, add, frames, scale, shift, ob, N, H, W, C,
                                           Cout, relu, wvec, cvec, stream);
  return vec ? dispatch_mma<true, false>(xb, wb, nullptr, 0, scale, shift, ob, N, H, W, C, Cout,
                                         relu, wvec, cvec, stream)
             : dispatch_mma<false, false>(xb, wb, nullptr, 0, scale, shift, ob, N, H, W, C, Cout,
                                          relu, wvec, cvec, stream);
}

}  // namespace kpvid_mma
