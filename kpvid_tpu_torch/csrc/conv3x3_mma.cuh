// The bf16 route of conv3x3.cu: the fused 3x3 SAME conv + affine + ReLU as an
// implicit GEMM on Hopper's tensor cores (bf16 in, f32 accumulation), with
// cp.async double buffering.
//
// GEMM view of one block: M = TH x TW = 16 x 16 output pixels, N = TN output
// channels (128, 64, or 8 for the 4-channel head), K = 9 taps x C, walked in
// chunks of CK = 32 input channels. Each of the 8 warps owns 2 output rows
// (16 pixels each, one m16 tile) and all TN channels. The 16-row tile halves
// the weight bytes each output pixel costs (every block stages the whole
// weight slice of its TN channels), which is what bounds an 8-row tile. For
// each chunk a stage holds
//   - the weight slice [9 * CK][TN] bf16, output channels innermost (HWIO
//     order, so it copies in 16-byte pieces);
//   - the (TH+2) x (TW+2) x CK halo of x, bf16, channels innermost, so one
//     pixel's k-slice is one 64-byte row, its 16-byte chunks XOR-swizzled
//     (swz below) so that every ldmatrix phase (8 rows of 16 bytes) is free
//     of bank conflicts.
// The nine taps reuse one halo: for tap (dy, dx) the A rows of output pixel
// (py, px) are halo pixel (py + dy, px + dx), and since an m16 tile is one
// output row (TW = 16), ldmatrix's one row address per lane gives the
// shifted rows for free. While chunk c is multiplied, cp.async (16 bytes,
// zero-filled through src-size 0 outside the image and past C) fills the
// other stage with chunk c + 1.
//
// The MMA is wgmma: each warpgroup (4 warps, 8 output rows) runs two
// m64nTNk16 per k16 step, one per group of 4 rows, with A from registers
// (ldmatrix.x4 from the halo: per warp the A layout of mma.sync.m16n8k16)
// and B read from shared memory through a descriptor in the canonical
// MN-major layout: for TN >= 64 with the 128-byte swizzle, as 64-channel
// atoms of [9 * CK rows][128 B], chunk j of row r at chunk j ^ (r % 8); for
// TN = 8 without a swizzle, one 16-byte row per k (8 rows make a core
// matrix). One step's wgmmas run while the next step's A fragments load.
//
// up2 (the TF1-legacy 2x upsample of x): a stage holds the low-resolution
// (TH/2+2) x (TW/2+2) x CK source tile instead of the halo; one more pass
// builds the upsampled bf16 halo from it in shared memory (along H, then W,
// edge-clamped, in f32, rounded once), then the same MMA loop runs. The
// upsampled activation never reaches device memory; every border is exact.
//
// VEC = false (C % 8 != 0, e.g. C = 4) takes an element-wise loader that
// zero-pads the channels; weights with Cout % 8 != 0 likewise. The epilogue
// applies acc * scale + shift and the optional ReLU in registers, rounds once
// to bf16, stages the tile through shared memory and stores 16-byte vectors.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace kpvid_mma {

constexpr int TW = 16;  // one m16 tile is one output row
constexpr int CK = 32;
constexpr int CPX = CK / 8;  // 16-byte chunks per halo pixel
constexpr int NTHREADS = 256;
constexpr int HW = TW + 2;
constexpr int LW = TW / 2 + 2;
constexpr int ATOM_B = 9 * CK * 128;  // a 64-channel atom of the weight slice

constexpr int align1k(int b) { return (b + 1023) / 1024 * 1024; }

// the tile of a block and its shared memory: two stages of [weights][x tile],
// 1024-byte aligned for the 128-byte swizzle
template <int TN, bool UP2>
struct Tile {
  static constexpr int TH = 16;                 // output rows
  static constexpr int MT = TH / 8;             // output rows (m16 tiles) of a warp
  static constexpr int HPIX = (TH + 2) * HW;    // halo pixels
  static constexpr int LPIX = (TH / 2 + 2) * LW;  // up2: low-resolution source pixels
  static constexpr int HALO_B = HPIX * CK * 2;
  static constexpr int W_B = 9 * CK * TN * 2;
  static constexpr int SRC_B = UP2 ? LPIX * CK * 2 : HALO_B;
  static constexpr int STAGE_B = align1k(W_B + SRC_B);
  // + the upsampled halo, + slack to align the base
  static constexpr int BYTES = 2 * STAGE_B + (UP2 ? HALO_B : 0) + 1024;
};

// chunk j (of CPX) of halo pixel p is stored at chunk swz(p, j): any 8
// consecutive pixels then cover the 8 bank groups of 16 bytes once
__device__ __forceinline__ int swz(int p, int j) { return j ^ ((p / (8 / CPX)) & (CPX - 1)); }

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

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// waits for this thread's copies, then orders them (and its plain stores)
// before the wgmma reads of the async proxy
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// shared-memory descriptor of the MN-major B operand. With the 128-byte
// swizzle (TN >= 64): LBO = the stride between 64-channel atoms, SBO = the
// stride between groups of 8 k-rows (1024 bytes). Without (TN = 8, one core
// matrix wide): the next 8 k-rows start 128 bytes on, and that is the only
// stride the k16 operand uses, so LBO and SBO both hold it.
template <int TN>
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
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

// D (m64 x N, f32) += A (m64 x k16 bf16, registers) * B (k16 x N bf16, MN-major
// in shared memory): per warp, d[j][0..3] is the m16n8 accumulator of
// columns 8j..8j+7
__device__ __forceinline__ void wgmma_n128(float (&d)[16][4], const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]),
        "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]),
        "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]),
        "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]),
        "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[8][4], const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_n8(float (&d)[1][4], const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// x: [N, H, W, C]; w: [3, 3, C, Cout]; out: [N, OH, OW, Cout], all bf16, with
// (OH, OW) = (H, W), or (2H, 2W) when UP2. cvec: the weights load and the
// output stores as 16-byte vectors (Cout % 8 == 0, both aligned). The 64-channel up2 tile is small
// enough in shared memory (107 KB) for two blocks an SM once its registers
// are held to 128 a thread; that overlaps one block's loads and halo build
// with the other's MMAs.
template <int TN, bool UP2, bool VEC>
__global__ void __launch_bounds__(NTHREADS, (TN == 64 && UP2) ? 2 : 1)
conv3x3_bf16_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                        const float* __restrict__ scale, const float* __restrict__ shift,
                        __nv_bfloat16* __restrict__ out, int H, int W, int C, int Cout, int OH,
                        int OW, int tiles_w, int tiles_per_img, int relu, int cvec) {
  static_assert(TN == 128 || TN == 64 || TN == 8, "tile width");
  constexpr int NT = TN / 8;  // n8 tiles of a warp
  using S = Tile<TN, UP2>;
  constexpr int TH = S::TH, MT = S::MT, HPIX = S::HPIX, LPIX = S::LPIX;
  extern __shared__ __align__(128) unsigned char mma_smem[];
  unsigned char* smem = mma_smem + ((1024 - (smem_u32(mma_smem) & 1023)) & 1023);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n = blockIdx.x / tiles_per_img;
  const int tile = blockIdx.x - n * tiles_per_img;
  const int oy0 = (tile / tiles_w) * TH;
  const int ox0 = (tile % tiles_w) * TW;
  const int co0 = blockIdx.y * TN;
  const __nv_bfloat16* xn = x + (size_t)n * H * W * C;
  const uint32_t sbase = smem_u32(smem);
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  // chunk ch of the input channels (and its weight rows) into stage s
  auto load_stage = [&](int ch, int s) {
    const int c0 = ch * CK;
    const uint32_t ws = sbase + s * S::STAGE_B;
    unsigned char* ws_p = smem + s * S::STAGE_B;
    const uint32_t xs = ws + S::W_B;
    unsigned char* xs_p = ws_p + S::W_B;
    // weight rows r = tap * CK + ci
    if (cvec) {
      for (int i = tid; i < 9 * CK * NT; i += NTHREADS) {
        const int r = i / NT, j = i % NT;
        const int tap = r / CK, c = c0 + r % CK, o = co0 + j * 8;
        const bool ok = c < C && o < Cout;
        const __nv_bfloat16* src = ok ? w + ((size_t)tap * C + c) * Cout + o : w;
        cp_async16(ws + w_off<TN>(r, j), src, ok);
      }
    } else {
      for (int i = tid; i < 9 * CK * TN; i += NTHREADS) {
        const int r = i / TN, co = i % TN;
        const int tap = r / CK, c = c0 + r % CK, o = co0 + co;
        *reinterpret_cast<__nv_bfloat16*>(ws_p + w_off<TN>(r, co >> 3) + (co & 7) * 2) =
            (c < C && o < Cout) ? w[((size_t)tap * C + c) * Cout + o] : zero;
      }
    }
    // x: the halo (or, for up2, the low-resolution source tile)
    if constexpr (!UP2) {
      if constexpr (VEC) {
        for (int i = tid; i < HPIX * CPX; i += NTHREADS) {
          const int p = i / CPX, j = i % CPX;
          const int gy = oy0 - 1 + p / HW, gx = ox0 - 1 + p % HW;
          const int c = c0 + j * 8;
          const bool ok = c < C && gy >= 0 && gy < H && gx >= 0 && gx < W;
          const __nv_bfloat16* src = ok ? xn + ((size_t)gy * W + gx) * C + c : xn;
          cp_async16(xs + p * (CK * 2) + swz(p, j) * 16, src, ok);
        }
      } else {
        for (int i = tid; i < HPIX * CK; i += NTHREADS) {
          const int p = i / CK, ci = i % CK;
          const int gy = oy0 - 1 + p / HW, gx = ox0 - 1 + p % HW;
          const int c = c0 + ci;
          const bool ok = c < C && gy >= 0 && gy < H && gx >= 0 && gx < W;
          *reinterpret_cast<__nv_bfloat16*>(xs_p + p * (CK * 2) + swz(p, ci >> 3) * 16 +
                                            (ci & 7) * 2) =
              ok ? xn[((size_t)gy * W + gx) * C + c] : zero;
        }
      }
    } else {
      // source rows oy0/2 - 1 .. oy0/2 + TH/2 and columns likewise, clamped
      // into the image: a clamped row is either the edge clamp of the
      // upsample or feeds only halo pixels outside the output, which are 0
      const int ly0 = oy0 / 2 - 1, lx0 = ox0 / 2 - 1;
      if constexpr (VEC) {
        for (int i = tid; i < LPIX * CPX; i += NTHREADS) {
          const int p = i / CPX, j = i % CPX;
          const int gy = min(max(ly0 + p / LW, 0), H - 1);
          const int gx = min(max(lx0 + p % LW, 0), W - 1);
          const int c = c0 + j * 8;
          const bool ok = c < C;
          const __nv_bfloat16* src = ok ? xn + ((size_t)gy * W + gx) * C + c : xn;
          cp_async16(xs + p * (CK * 2) + j * 16, src, ok);
        }
      } else {
        for (int i = tid; i < LPIX * CK; i += NTHREADS) {
          const int p = i / CK, ci = i % CK;
          const int gy = min(max(ly0 + p / LW, 0), H - 1);
          const int gx = min(max(lx0 + p % LW, 0), W - 1);
          const int c = c0 + ci;
          *reinterpret_cast<__nv_bfloat16*>(xs_p + (p * CK + ci) * 2) =
              c < C ? xn[((size_t)gy * W + gx) * C + c] : zero;
        }
      }
    }
  };

  // up2: the upsampled halo from the source tile of stage s
  auto build_halo = [&](int s) {
    const unsigned char* src = smem + s * S::STAGE_B + S::W_B;
    unsigned char* halo = smem + 2 * S::STAGE_B;
    for (int i = tid; i < HPIX * CPX; i += NTHREADS) {
      const int p = i / CPX, j = i % CPX;
      const int hy = p / HW, hx = p % HW;
      const int gy = oy0 - 1 + hy, gx = ox0 - 1 + hx;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gy >= 0 && gy < OH && gx >= 0 && gx < OW) {
        const int ty = (gy >> 1) - (oy0 / 2 - 1), tx = (gx >> 1) - (ox0 / 2 - 1);
        const int ty1 = ty + (gy & 1), tx1 = tx + (gx & 1);
        const uint4 q00 = *reinterpret_cast<const uint4*>(src + (ty * LW + tx) * (CK * 2) + j * 16);
        const uint4 q10 = *reinterpret_cast<const uint4*>(src + (ty1 * LW + tx) * (CK * 2) + j * 16);
        const uint4 q01 = *reinterpret_cast<const uint4*>(src + (ty * LW + tx1) * (CK * 2) + j * 16);
        const uint4 q11 = *reinterpret_cast<const uint4*>(src + (ty1 * LW + tx1) * (CK * 2) + j * 16);
        const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&q00);
        const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&q10);
        const __nv_bfloat162* c = reinterpret_cast<const __nv_bfloat162*>(&q01);
        const __nv_bfloat162* d = reinterpret_cast<const __nv_bfloat162*>(&q11);
        __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float2 u = __bfloat1622float2(a[e]);
          if (gy & 1) {
            const float2 t = __bfloat1622float2(b[e]);
            u = make_float2((u.x + t.x) * 0.5f, (u.y + t.y) * 0.5f);
          }
          if (gx & 1) {
            float2 r = __bfloat1622float2(c[e]);
            if (gy & 1) {
              const float2 t = __bfloat1622float2(d[e]);
              r = make_float2((r.x + t.x) * 0.5f, (r.y + t.y) * 0.5f);
            }
            u = make_float2((u.x + r.x) * 0.5f, (u.y + r.y) * 0.5f);
          }
          o[e] = __floats2bfloat162_rn(u.x, u.y);
        }
      }
      *reinterpret_cast<uint4*>(halo + p * (CK * 2) + swz(p, j) * 16) = v;
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  // output row of the warp's m16 tile mt: warpgroup g covers rows 4 * MT * g
  // onwards, its warp q row q of each group of 4 (the m64 of a wgmma)
  auto out_row = [&](int mt) { return (warp >> 2) * 4 * MT + 4 * mt + (warp & 3); };
  // ldmatrix lanes: A row = pixel (lane & 15) of an output row, k half lane >> 4
  const int l16 = lane & 15;
  const int lhi = lane >> 4;
  constexpr int STEPS = 9 * CK / 16;  // k16 steps of a chunk: weight rows 16 * step..

  const int nch = (C + CK - 1) / CK;
  load_stage(0, 0);
  cp_async_commit();
  for (int ch = 0; ch < nch; ++ch) {
    const int s = ch & 1;
    cp_async_wait_all();
    __syncthreads();  // stage s is in; every warp is done with stage s ^ 1
    if (ch + 1 < nch) load_stage(ch + 1, s ^ 1);
    cp_async_commit();
    const uint32_t wsm = sbase + s * S::STAGE_B;
    uint32_t halo = wsm + S::W_B;
    if constexpr (UP2) {
      build_halo(s);
      __syncthreads();
      halo = sbase + 2 * S::STAGE_B;
    }
    // the A fragments of k16 step `step` (tap = step / (CK / 16)), one per m16 tile
    auto load_a = [&](int step, uint32_t(&a)[MT][4]) {
      const int tap = step / (CK / 16), kk = step % (CK / 16);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int hp = (out_row(mt) + tap / 3) * HW + l16 + tap % 3;
        ldmatrix_x4(a[mt], halo + hp * (CK * 2) + swz(hp, kk * 2 + lhi) * 16);
      }
    };
    // one step's wgmmas in flight while the next A fragments load
    uint32_t a[2][MT][4];
    load_a(0, a[0]);
#pragma unroll
    for (int step = 0; step < STEPS; ++step) {
      wgmma_fence();
      const uint64_t desc = b_desc<TN>(wsm + w_off<TN>(step * 16, 0));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if constexpr (TN == 128) {
          wgmma_n128(acc[mt], a[step & 1][mt], desc);
        } else if constexpr (TN == 64) {
          wgmma_n64(acc[mt], a[step & 1][mt], desc);
        } else {
          wgmma_n8(acc[mt], a[step & 1][mt], desc);
        }
      }
      wgmma_commit();
      if (step + 1 < STEPS) {
        wgmma_wait<1>();
        load_a(step + 1, a[(step + 1) & 1]);
      }
    }
    wgmma_wait<0>();  // done with stage s before any warp refills it
  }
  cp_async_wait_all();
  __syncthreads();  // every warp is done with the stages: reuse them for the output tile
  // keep the compiler from reading the accumulators above the last wgmma wait
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(acc[mt][nt][e])::"memory");

  // epilogue: affine + ReLU in registers, one rounding, through shared memory
  constexpr int OST = TN + 8;  // padded row of the output tile, in elements
  __nv_bfloat16* otile = reinterpret_cast<__nv_bfloat16*>(smem);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int nl = nt * 8 + (lane & 3) * 2;
    const int o = co0 + nl;
    const float s0 = o < Cout ? scale[o] : 0.f, t0 = o < Cout ? shift[o] : 0.f;
    const float s1 = o + 1 < Cout ? scale[o + 1] : 0.f, t1 = o + 1 < Cout ? shift[o + 1] : 0.f;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = out_row(mt) * TW + (lane >> 2) + h * 8;
        float y0 = acc[mt][nt][2 * h] * s0 + t0;
        float y1 = acc[mt][nt][2 * h + 1] * s1 + t1;
        if (relu) {
          y0 = fmaxf(y0, 0.f);
          y1 = fmaxf(y1, 0.f);
        }
        *reinterpret_cast<__nv_bfloat162*>(otile + m * OST + nl) = __floats2bfloat162_rn(y0, y1);
      }
  }
  __syncthreads();
  for (int i = tid; i < TH * TW * NT; i += NTHREADS) {
    const int m = i / NT, j = i % NT;
    const int oy = oy0 + m / TW, ox = ox0 + m % TW, o = co0 + j * 8;
    if (oy >= OH || ox >= OW || o >= Cout) continue;
    __nv_bfloat16* dst = out + (((size_t)n * OH + oy) * OW + ox) * Cout + o;
    const __nv_bfloat16* src = otile + m * OST + j * 8;
    if (cvec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && o + e < Cout; ++e) dst[e] = src[e];
    }
  }
}

template <int TN, bool UP2, bool VEC>
cudaError_t launch_mma(const __nv_bfloat16* x, const __nv_bfloat16* w, const float* scale,
                       const float* shift, __nv_bfloat16* out, int N, int H, int W, int C,
                       int Cout, int relu, int cvec, cudaStream_t stream) {
  auto kern = conv3x3_bf16_mma_kernel<TN, UP2, VEC>;
  constexpr int smem = Tile<TN, UP2>::BYTES;
  constexpr int TH = Tile<TN, UP2>::TH;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int OH = UP2 ? 2 * H : H;
  const int OW = UP2 ? 2 * W : W;
  const int tiles_w = (OW + TW - 1) / TW;
  const int tiles_per_img = ((OH + TH - 1) / TH) * tiles_w;
  dim3 grid((unsigned)(N * tiles_per_img), (unsigned)((Cout + TN - 1) / TN));
  kern<<<grid, NTHREADS, smem, stream>>>(x, w, scale, shift, out, H, W, C, Cout, OH, OW, tiles_w,
                                         tiles_per_img, relu, cvec);
  return cudaGetLastError();
}

template <bool UP2, bool VEC>
cudaError_t dispatch_mma(const __nv_bfloat16* x, const __nv_bfloat16* w, const float* scale,
                         const float* shift, __nv_bfloat16* out, int N, int H, int W, int C,
                         int Cout, int relu, int cvec, cudaStream_t stream) {
  // 128 output channels a block for the wide layers, 64 for C' = 64 (a
  // 128-wide tile would idle half its lanes), 8 for the 4-channel head
  if (Cout >= 128)
    return launch_mma<128, UP2, VEC>(x, w, scale, shift, out, N, H, W, C, Cout, relu, cvec,
                                     stream);
  if (Cout > 8)
    return launch_mma<64, UP2, VEC>(x, w, scale, shift, out, N, H, W, C, Cout, relu, cvec,
                                    stream);
  return launch_mma<8, UP2, VEC>(x, w, scale, shift, out, N, H, W, C, Cout, relu, cvec, stream);
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

inline cudaError_t conv3x3_bf16(int up2, const void* x, const void* w, const float* scale,
                                const float* shift, void* out, int N, int H, int W, int C,
                                int Cout, int relu, cudaStream_t stream) {
  auto xb = static_cast<const __nv_bfloat16*>(x);
  auto wb = static_cast<const __nv_bfloat16*>(w);
  auto ob = static_cast<__nv_bfloat16*>(out);
  const bool vec = C % 8 == 0 && aligned16(x);
  const int cvec = Cout % 8 == 0 && aligned16(w) && aligned16(out);
  if (up2)
    return vec ? dispatch_mma<true, true>(xb, wb, scale, shift, ob, N, H, W, C, Cout, relu,
                                            cvec, stream)
               : dispatch_mma<true, false>(xb, wb, scale, shift, ob, N, H, W, C, Cout, relu,
                                             cvec, stream);
  return vec ? dispatch_mma<false, true>(xb, wb, scale, shift, ob, N, H, W, C, Cout, relu, cvec,
                                           stream)
             : dispatch_mma<false, false>(xb, wb, scale, shift, ob, N, H, W, C, Cout, relu,
                                            cvec, stream);
}

}  // namespace kpvid_mma
