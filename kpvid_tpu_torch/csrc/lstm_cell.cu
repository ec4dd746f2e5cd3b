// One step of one LSTM layer of the motion decode, for Hopper (sm_90a):
// the gate product on the tensor cores and the cell update in the epilogue.
//
// Replaces no TPU kernel: XLA fuses the jnp LSTM cell of the JAX package's
// StackedLSTM (kpvid_tpu/models/layers.py), a preferred_element_type=f32 dot
// and the gates, with no pallas_call. In eager PyTorch a step and layer was a
// cat, casts, an f32 SIMT sgemm of the bf16-rounded operands widened to f32,
// a bias add and ~10 elementwise passes over the gates (models/layers.py).
// This kernel computes, for x [B, D] and h [B, H] in bf16, c [B, H] f32, the
// kernel W [D+H, 4H] in bf16 and the bias [4H] f32:
//
//   gates = [x, h] @ W + bias      bf16 x bf16 products, exact in f32, summed
//                                  in f32 (mma.sync m16n8k16 over each 16-deep
//                                  tile, the tiles' sums added in f32)
//   i, j, f, o = the four H-wide column groups of gates
//   c' = sigmoid(f + 1) * c + sigmoid(i) * tanh(j)
//   h' = sigmoid(o) * tanh(c')     -> h' f32, c' f32 and h' rounded to bf16
//
// with sigmoid(v) = 1 / (1 + expf(-v)) and tanhf, each step rounded to f32 as
// the torch passes round it (the _rn intrinsics keep nvcc from contracting a
// multiply and an add into an FMA). Only the order of the f32 sums of the
// product differs from the torch route; it is fixed (no atomics), so a call
// gives the same bits every time.
//
// Bound on the card: the weight bytes. At batch 32 the product does ~32
// operations a byte of W, far under the ~295 where the tensor cores would be
// the limit, so the design moves W once and keeps everything else on chip:
//   - a block owns U hidden units and reads the four gate columns of each
//     (i, j, f, o at u, H + u, 2H + u, 3H + u), so the cell update runs in
//     its epilogue and the [B, 4H] gates never reach memory; U = 16 gives
//     32-byte column runs, whole sectors of L2;
//   - the block's eight warps split its part of the reduction (K = D + H)
//     into eight contiguous ranges of 16-row tiles; each warp streams its
//     tiles of W and of [x, h] through its own ring of shared memory by
//     16-byte cp.async copies, several tiles in flight, and reads them with
//     ldmatrix (W transposed) from XOR-swizzled rows, free of bank conflicts;
//   - a cluster of SPLIT = 2 blocks shares each group of units, each block a
//     contiguous half of the reduction, so that 128 blocks fill the card at
//     H = 1024; the warps' partial sums meet in shared memory and are added
//     in warp order, then the blocks' in rank order through distributed
//     shared memory (k ascending both times), then the bias, then the cell;
//   - each thread reads its outputs' cell state and biases before the main
//     loop, so that their latency hides under it;
//   - the batch is padded to 16 rows a tile (mma.sync; wgmma's 64 rows would
//     waste most of the tile at B <= 32); blocks of 16 or 32 rows, a second
//     grid axis over batch tiles for any B.
// x and h come in as two pointers (no cat). Shapes or pointers that the
// 16-byte copies cannot take (D or H not a multiple of 8, a row stride not a
// multiple of 8, a pointer off a 16-byte boundary) take the same kernel with
// element-by-element loads.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 8;
constexpr int NTHREADS = WARPS * 32;
constexpr int STAGES = 4;
constexpr int UNITS = 16;           // hidden units a block
constexpr int SPLIT = 2;            // blocks of a cluster that split one group of units' K
constexpr int NCOL = 4 * UNITS;     // gate columns a block: 64
constexpr int NCH = NCOL / 8;       // 16-byte chunks of a W tile's row: 8
constexpr int NTILE = NCOL / 8;     // mma n-tiles: 8
constexpr int RED_LD = NCOL + 4;    // row stride of the partial sums, floats

template <int MT>
struct Tile {
  static constexpr int W_BYTES = 16 * NCOL * 2;             // 16 k-rows of W
  static constexpr int A_BYTES = MT * 16 * 16 * 2;          // MT * 16 batch rows, 16 k
  static constexpr int STAGE = W_BYTES + A_BYTES;
  static constexpr int RING = WARPS * STAGES * STAGE;
  static constexpr int RED = WARPS * MT * 16 * RED_LD * 4;  // the warps' f32 partials
  static constexpr int PART = MT * 16 * NCOL * 4;           // the block's f32 sums
  static constexpr int SMEM = RING > RED + PART ? RING : RED + PART;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global, or zeros where ``valid`` is false
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// acc += the 16-deep product a x b, summed by the tensor cores from zero and
// then added to acc in f32 with round-to-nearest: the tensor cores align a
// running sum's addends to its largest and cut the bits below, so carrying
// the sum across k-tiles inside the mma would lose up to a unit in the last
// place of the sum at every tile
__device__ __forceinline__ void mma_bf16(float (&acc)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  float d[4];
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.0f));
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] = __fadd_rn(acc[e], d[e]);
}

// byte offset of 16-byte chunk c of row r in a W tile (NCH chunks a row,
// 8 / NCH rows to a 128-byte line): the chunk index XOR the line's index, so
// the 8 rows an ldmatrix reads at one chunk fall in 8 different bank groups
__device__ __forceinline__ int w_off(int r, int c) {
  return r * (NCOL * 2) + ((c ^ ((r / (8 / NCH)) & (NCH - 1))) << 4);
}

// the same for an A tile (32-byte rows, 4 to a 128-byte line)
__device__ __forceinline__ int a_off(int r, int c) { return r * 32 + ((c ^ ((r >> 2) & 1)) << 4); }

struct Args {
  const __nv_bfloat16* x;  // [B, D], row stride ldx
  const __nv_bfloat16* h;  // [B, H], row stride ldh
  const float* c;          // [B, H]
  const __nv_bfloat16* w;  // [D + H, 4H]
  const float* bias;       // [4H]
  float* h_out;            // [B, H]
  float* c_out;            // [B, H]
  __nv_bfloat16* h16_out;  // [B, H]
  long long ldx, ldh;
  int B, D, H;
};

__device__ __forceinline__ float sigmoid(float v) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-v)));
}

// Fill ring slot ``slot`` with k-tile ``kt``: W rows kt*16.. of the block's
// columns and [x, h] rows b0.. of the same k. VEC: 16-byte cp.async copies;
// otherwise element by element.
template <int MT, bool VEC>
__device__ __forceinline__ void load_tile(const Args& a, char* slot, int kt, int u0, int b0,
                                          int lane) {
  const int K = a.D + a.H;
  const long long ldw = 4LL * a.H;
  char* ws = slot;
  char* as = slot + Tile<MT>::W_BYTES;
#pragma unroll
  for (int i = 0; i < 16 * NCH / 32; ++i) {
    const int q = lane + 32 * i;
    const int r = q / NCH, ch = q % NCH;
    const int k = kt * 16 + r;
    const int g = ch / (UNITS / 8), u = u0 + (ch % (UNITS / 8)) * 8;
    const __nv_bfloat16* src = a.w + k * ldw + static_cast<long long>(g) * a.H + u;
    if (VEC) {
      const bool ok = k < K && u < a.H;
      cp_async16(ws + w_off(r, ch), ok ? src : a.w, ok);
    } else {
      alignas(16) __nv_bfloat16 v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[e] = (k < K && u + e < a.H) ? src[e] : __float2bfloat16_rn(0.0f);
      }
      *reinterpret_cast<uint4*>(ws + w_off(r, ch)) = *reinterpret_cast<const uint4*>(v);
    }
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int q = lane + 32 * i;
    const int r = q / 2, ch = q % 2;
    const int b = b0 + r;
    const int k = kt * 16 + ch * 8;
    if (VEC) {
      const bool ok = b < a.B && k < K;
      const __nv_bfloat16* src =
          !ok ? a.x : (k < a.D ? a.x + b * a.ldx + k : a.h + b * a.ldh + (k - a.D));
      cp_async16(as + a_off(r, ch), src, ok);
    } else {
      alignas(16) __nv_bfloat16 v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int kk = k + e;
        v[e] = (b >= a.B || kk >= K) ? __float2bfloat16_rn(0.0f)
               : kk < a.D            ? a.x[b * a.ldx + kk]
                                     : a.h[b * a.ldh + (kk - a.D)];
      }
      *reinterpret_cast<uint4*>(as + a_off(r, ch)) = *reinterpret_cast<const uint4*>(v);
    }
  }
}

// grid: (ceil(H / UNITS) * SPLIT, ceil(B / (16 * MT))), clusters of SPLIT
// blocks along x; NTHREADS threads
template <int MT, bool VEC>
__global__ void __cluster_dims__(SPLIT, 1, 1) __launch_bounds__(NTHREADS)
lstm_cell_kernel(const Args a) {
  extern __shared__ __align__(128) char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int u0 = (blockIdx.x / SPLIT) * UNITS;
  const int b0 = blockIdx.y * MT * 16;
  // the cluster's blocks take contiguous ranges of the 16-row tiles, in
  // rank order, and each block's warps contiguous ranges of its own
  const int kts = (a.D + a.H + 15) / 16;
  const int c0 = rank * kts / SPLIT, cn = (rank + 1) * kts / SPLIT - c0;
  const int kt0 = c0 + warp * cn / WARPS, n = c0 + (warp + 1) * cn / WARPS - kt0;
  char* ring = smem + warp * STAGES * Tile<MT>::STAGE;

  // the cluster's ROWS x UNITS outputs are dealt over its blocks' threads,
  // PER a thread; each thread reads its outputs' cell state and biases now,
  // so that their latency hides under the main loop
  constexpr int ROWS = MT * 16;
  constexpr int PER = (ROWS * UNITS + SPLIT * NTHREADS - 1) / (SPLIT * NTHREADS);
  float c_in[PER], bias_in[PER][4];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int p = rank * NTHREADS + threadIdx.x + i * SPLIT * NTHREADS;
    const int b = b0 + p / UNITS, u = u0 + p % UNITS;
    const bool ok = p < ROWS * UNITS && b < a.B && u < a.H;
    c_in[i] = ok ? a.c[static_cast<long long>(b) * a.H + u] : 0.0f;
#pragma unroll
    for (int g = 0; g < 4; ++g) bias_in[i][g] = ok ? a.bias[g * a.H + u] : 0.0f;
  }

  float acc[MT][NTILE][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NTILE; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n) load_tile<MT, VEC>(a, ring + s * Tile<MT>::STAGE, kt0 + s, u0, b0, lane);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncwarp();  // the tile's copies by every lane are in; slot i - 1 is read by all
    const int next = i + STAGES - 1;
    if (next < n) {
      load_tile<MT, VEC>(a, ring + (next % STAGES) * Tile<MT>::STAGE, kt0 + next, u0, b0, lane);
    }
    cp_async_commit();
    const char* ws = ring + (i % STAGES) * Tile<MT>::STAGE;
    const char* as = ws + Tile<MT>::W_BYTES;
    uint32_t af[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) ldmatrix_x4(af[m], as + a_off(m * 16 + (lane & 15), lane >> 4));
#pragma unroll
    for (int jp = 0; jp < NTILE / 2; ++jp) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, ws + w_off(lane & 15, 2 * jp + (lane >> 4)));
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        mma_bf16(acc[m][2 * jp], af[m], bf[0], bf[1]);
        mma_bf16(acc[m][2 * jp + 1], af[m], bf[2], bf[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every ring is done: the partial sums take their place

  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NTILE; ++j) {
      const int r = m * 16 + lane / 4, col = j * 8 + (lane % 4) * 2;
      float* p = red + (warp * ROWS + r) * RED_LD + col;
      p[0] = acc[m][j][0];
      p[1] = acc[m][j][1];
      p[8 * RED_LD] = acc[m][j][2];
      p[8 * RED_LD + 1] = acc[m][j][3];
    }
  __syncthreads();
  // the block's sums over its warps, in warp order (k ascending)
  float* part = red + WARPS * ROWS * RED_LD;
  for (int v = threadIdx.x; v < ROWS * NCOL; v += NTHREADS) {
    const int r = v / NCOL, col = v % NCOL;
    float s = red[r * RED_LD + col];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) s = __fadd_rn(s, red[(w * ROWS + r) * RED_LD + col]);
    part[v] = s;
  }
  cluster.sync();  // every block's sums are in its shared memory

  // each output adds the blocks' sums in rank order (k ascending), the
  // others' through distributed shared memory
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int p = rank * NTHREADS + threadIdx.x + i * SPLIT * NTHREADS;
    const int r = p / UNITS, uu = p % UNITS;
    const int b = b0 + r, u = u0 + uu;
    if (p >= ROWS * UNITS || b >= a.B || u >= a.H) continue;
    float gate[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int v = r * NCOL + g * UNITS + uu;
      float s = 0.0f;
#pragma unroll
      for (int q = 0; q < SPLIT; ++q) {
        const float t = q == rank ? part[v] : cluster.map_shared_rank(part, q)[v];
        s = q == 0 ? t : __fadd_rn(s, t);
      }
      gate[g] = __fadd_rn(s, bias_in[i][g]);
    }
    const long long o = static_cast<long long>(b) * a.H + u;
    const float c = __fadd_rn(__fmul_rn(sigmoid(__fadd_rn(gate[2], 1.0f)), c_in[i]),
                              __fmul_rn(sigmoid(gate[0]), tanhf(gate[1])));
    const float h = __fmul_rn(sigmoid(gate[3]), tanhf(c));
    a.c_out[o] = c;
    a.h_out[o] = h;
    a.h16_out[o] = __float2bfloat16_rn(h);
  }
  cluster.sync();  // no block leaves while another reads its partial sums
}

template <int MT, bool VEC>
int launch(const Args& a, cudaStream_t s) {
  auto kern = lstm_cell_kernel<MT, VEC>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Tile<MT>::SMEM);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid((a.H + UNITS - 1) / UNITS * SPLIT, (a.B + MT * 16 - 1) / (MT * 16));
  kern<<<grid, NTHREADS, Tile<MT>::SMEM, s>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// x [B, D] and h [B, H] bfloat16 with row strides ldx and ldh (elements), c
// [B, H] f32, w [D + H, 4H] bfloat16 and bias [4H] f32, all dense but for
// the two row strides; writes h_out and c_out [B, H] f32 and h16_out [B, H]
// bfloat16. Returns the cudaError_t of the launch (0 on success).
int kpvid_lstm_cell(const void* x, long long ldx, const void* h, long long ldh, const float* c,
                    const void* w, const float* bias, float* h_out, float* c_out, void* h16_out,
                    int B, int D, int H, void* stream) {
  if (B < 0 || D < 0 || H < 1 || ldx < D || ldh < H) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  Args a{static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(h), c,
         static_cast<const __nv_bfloat16*>(w), bias, h_out, c_out,
         static_cast<__nv_bfloat16*>(h16_out), ldx, ldh, B, D, H};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = D % 8 == 0 && H % 8 == 0 && ldx % 8 == 0 && ldh % 8 == 0 && aligned16(x) &&
                   aligned16(h) && aligned16(w);
  if (B <= 16) return vec ? launch<1, true>(a, s) : launch<1, false>(a, s);
  return vec ? launch<2, true>(a, s) : launch<2, false>(a, s);
}

const char* kpvid_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
