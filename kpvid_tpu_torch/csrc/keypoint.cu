// The keypoint path's two kernels for Hopper (sm_90a): the spatial soft-argmax
// of the pose head and the Gaussian render, NHWC, f32 arithmetic.
//
// pose_head replaces kpvid_tpu/ops/pallas_kernels.py::pose_head_pallas (the
// pl.pallas_call at pallas_kernels.py:92): raw heatmaps [B, H, W, K] in f32
// or bf16 -> keypoints [B, K, 2] (x, y) in f32. x is the soft-argmax of the
// mean over H (the W-marginal), y that of the mean over W (the H-marginal), on
// the inclusive [-1, 1] grids. Bound on the card: the heatmap's bytes, read
// once (5.2 MB at batch 4 and 42 MB at batch 32 in bf16, 1.6 and 12.5 us at
// 3.35 TB/s). The TPU kernel carries the W-marginal from one grid step to the
// next in scratch memory; blocks on the card run in no order, so here a
// thread-block cluster takes one image:
//   - cluster size 8, the portable maximum. Each block takes a band of
//     ceil(H / 8) rows (16 at H = 128), which is contiguous in NHWC, so batch 4
//     runs 32 blocks (32 of the 132 SMs) and batch 32 runs 256 blocks. A
//     block holds 69 KB of shared memory and 256 threads, so three fit a SM
//     and the 32 clusters of batch 32 can all be resident at once;
//   - a block streams its band through shared memory in chunks of up to
//     20 KB (2 rows at Config()), two buffers (one chunk in flight while the
//     block sums the other), 16-byte cp.async copies,
//     converts to f32 in registers and accumulates the W-marginal's partial
//     sums [W, K] (each thread owns 16-byte column slots) and the band's
//     means over W [rows, K] (a warp per row and 16-byte channel group, lanes
//     over W, a shuffle tree). Every sum has one owner and a fixed order, so
//     no atomics are needed. K not a multiple of 16 bytes takes an
//     element-wise loader and sums (a template flag, as the conv has);
//   - each block transposes its partials to channel-major; after
//     cluster.sync() block r gathers the marginals of its ceil(K / 8)
//     channels from its peers' shared memory (map_shared_rank), each
//     channel's run of floats in whole lines, the W-marginal summed over the
//     ranks in order; a second cluster.sync() ends every remote read before
//     any block can exit. It then takes both softmaxes in the form of
//     ops/coords.py::heatmaps_to_keypoints, one warp per (channel, axis).
//     One launch, a fixed order of every sum: a seed gives the same points
//     twice.
//
// gaussian_render replaces pallas_kernels.py::gaussian_render_pallas
// (pallas_kernels.py:146): keypoints [N, K, 2] f32 -> maps [N, H, W, K] in f32
// or bf16, exp(-(gy - my)^2 c2) * exp(-(gx - mx)^2 c2). Bound: the output's
// bytes, written once. A block takes a band of rows of one frame, sized so that
// the grid holds about four blocks a SM (one row a block for the 4 current maps
// of a batch-4 call, whole 32-row frames at 1,024 frames). It first computes
// ey [rows, K] and ex [W, K] into shared memory, K (rows + W) exponentials
// (expf, not __expf), then forms each product in f32, rounds it once to the
// output type and stores along the contiguous NHWC rows in 16-byte vectors
// (4 f32 or 8 bf16 channels); K not a multiple of the vector takes scalar
// stores. The grid values and c2 come from the caller (ops/coords.py::grid
// and inv_std_squared), so a bf16 grid keeps JAX's values.
//
// The backwards. The TPU kernels have no VJP (JAX trains through the jnp
// forms by autodiff); these two are the port's counterparts of that autodiff,
// for stage-1 training.
//
// pose_head_backward: with p_w = softmax_w(mean_h raw), q_h = softmax_h(mean_w
// raw) and (x, y) the forward's points, d raw[b, h, w, k] = g_x p_w (gx_w - x)
// / H + g_y q_h (gy_h - y) / W, in f32, rounded once to the maps' dtype (what
// the VJP of JAX's raw.astype(f32) does). The forward's training form writes
// p [B, K, W] and q [B, K, H] in f32 (1.3 MB at batch 32), so the backward
// reads no map: it is a separable write, cy[h, k] + cx[w, k]. Bound: the
// gradient's bytes, written once (41.9 MB in bf16 at [32, 128, 128, 40],
// 12.5 us at 3.35 TB/s). The design is paid for by the write alone:
//   - one wave of blocks: G = SMs / B blocks an image (4 at batch 32 on 132
//     SMs: 128 blocks), block j taking the rows j, j + G, ..., so that the G
//     blocks of an image write neighbouring rows at the same time; a thread
//     for each (column, 16-byte channel group) of a row (640 at 128 x 40
//     bf16, at most 1,024, which then take the columns in chunks), so a
//     block's prologue is paid against many rows;
//   - the prologue is one round trip: each thread loads the W-marginal's term
//     of its own column and channels, cx[w, k0:k0+V], into registers, and
//     while those loads are in flight the block stages cy [rows, K] from q
//     with coalesced loads (lanes along the rows of q[b, k, :], four channels
//     a thread) written transposed into shared memory, rows padded to an odd
//     count of 16-byte units so that the stores hit distinct banks;
//   - the write loop has no division: a thread walks down its column, adds
//     the row's cy (a broadcast read of shared memory) to the cx it holds and
//     stores 16 bytes (4 f32 or 8 bf16 channels, or one channel where K is
//     not a multiple of the vector); a warp's stores cover 512 contiguous
//     bytes of a row. The stores carry the evict-first hint, so that L2
//     writes the 41.9 MB back to HBM as it arrives instead of holding it
//     dirty until later lines push it out.

// gaussian_render_backward: d mu_x[n, k] = 2 c2 sum_{h,w} G ey_h ex_w (gx_w -
// mu_x), d mu_y likewise with (gy_h - mu_y), from the maps' cotangent G in
// the maps' dtype, widened to f32. Bound: one read of G (1.3 MB in bf16 at
// [16, 32, 32, 40], 0.4 us at 3.35 TB/s), which no launch reaches: the kernel
// is bound by latency, and its design cuts the chain of dependent steps:
//   - a cluster of 8 blocks a frame (128 blocks at N = 16), block r a band of
//     ceil(H / 8) rows (4 rows, 10 KB at 32^2 bf16; bands may be short or
//     empty);
//   - each thread owns one column w and one 16-byte channel group and loads
//     its band's rows of that slot with 16-byte loads (coalesced across the
//     threads of a row), issued before the prologue computes ey and
//     ey (gy - my) of the band into shared memory, so both latencies overlap;
//     it sums G ey and G ey (gy - my) over the rows in registers, then
//     multiplies by its column's ex (gx - mx) and ex: the sum is separable, so
//     a thread takes only V exponentials of its own;
//   - the threads' partials are summed in shared memory in a fixed order, and
//     each block writes its sum of every output into the shared memory of
//     the rank that finishes it (map_shared_rank), once a barrier begun at
//     the kernel's start says every block runs; after cluster.sync() block r
//     sums its share of the 2K outputs over the 8 ranks in rank order from
//     its own shared memory. No block reads another's shared memory, so none
//     waits at a last barrier before it exits. No atomics: a rerun gives the
//     same bits.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 8;
constexpr int PH_THREADS = 256;
constexpr int PH_WARPS = PH_THREADS / 32;
constexpr int MAX_RC = 8;            // rows of one staged chunk, at most
constexpr int STAGE_BYTES = 20480;   // one staging buffer, at least a row
constexpr int NSTAGE = 2;            // staging buffers: NSTAGE - 1 copies in flight
constexpr size_t MAX_SMEM = 232448;  // a block's shared memory on an H100
constexpr int GR_THREADS = 256;
constexpr int GR_BLOCKS_PER_SM = 4;
constexpr int PB_THREADS = 1024;  // the soft-argmax's backward: threads a block, at most
constexpr int PB_ROWS = 64;       // rows of cy it stages at once, at most
constexpr int RB_THREADS = 256;  // the render's backward: threads a block
constexpr int RB_RC = 4;         // rows of one column slot a thread loads at once

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// the f32 values of 16 bytes held in registers: 4 f32 or 8 bf16
__device__ __forceinline__ void widen16(const uint4& q, float* v, const float*) {
  v[0] = __uint_as_float(q.x);
  v[1] = __uint_as_float(q.y);
  v[2] = __uint_as_float(q.z);
  v[3] = __uint_as_float(q.w);
}
__device__ __forceinline__ void widen16(const uint4& q, float* v, const __nv_bfloat16*) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

// V f32 values from 16 bytes of shared memory (4 f32 or 8 bf16)
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* v) {
  widen16(*reinterpret_cast<const uint4*>(p), v, p);
}

// V f32 values from 16-byte aligned shared memory: 16-byte loads where V is a
// multiple of 4, else one at a time
template <int V>
__device__ __forceinline__ void load_f32v(const float* s, float* v) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int j = 0; j < V; j += 4) {
      const float4 q = *reinterpret_cast<const float4*>(s + j);
      v[j] = q.x;
      v[j + 1] = q.y;
      v[j + 2] = q.z;
      v[j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = s[j];
  }
}

// one 16-byte vector of T (VEC) or one element, loaded from device memory now
// and widened to f32 when it is used
template <typename T, bool VEC>
struct Raw {
  uint4 q;
  __device__ __forceinline__ void load(const T* p) { q = __ldg(reinterpret_cast<const uint4*>(p)); }
  __device__ __forceinline__ void widen(float* v) const { widen16(q, v, static_cast<const T*>(nullptr)); }
};
template <typename T>
struct Raw<T, false> {
  T x;
  __device__ __forceinline__ void load(const T* p) { x = *p; }
  __device__ __forceinline__ void widen(float* v) const { v[0] = to_f32(x); }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Byte offsets of the pose head's shared memory, the same in every block of a
// cluster (peers address each other's arrays by these offsets).
struct PoseLayout {
  int band;  // rows a block takes
  int rc;    // rows a chunk stages
  int wl;    // threads that share one channel's columns (element-wise path)
  int nk;    // channels a block finishes, at most
  size_t col, rm, part, fx, fy, total;
};

__host__ __device__ inline PoseLayout pose_layout(int H, int W, int K, int elem, bool vec) {
  PoseLayout L;
  L.band = (H + CLUSTER - 1) / CLUSTER;
  const long row_bytes = (long)W * K * elem;
  int rc = (int)(STAGE_BYTES / row_bytes);
  rc = rc < 1 ? 1 : (rc > MAX_RC ? MAX_RC : rc);
  L.rc = rc < L.band ? rc : L.band;
  L.wl = PH_THREADS / K > 1 ? PH_THREADS / K : 1;
  L.nk = (K + CLUSTER - 1) / CLUSTER;
  // region A: the staging buffers, and after the band the transposed
  // partials [K, W] and [K, band] that the peers read
  const size_t stage = (size_t)NSTAGE * L.rc * row_bytes;
  const size_t trans = ((size_t)W + L.band) * K * 4;
  L.col = ((stage > trans ? stage : trans) + 15) / 16 * 16;
  L.rm = L.col + (size_t)W * K * 4;                         // W-marginal partials [W, K]
  L.part = L.rm + (size_t)L.band * K * 4;                   // the band's means over W
  L.fx = L.part + (vec ? 0 : (size_t)L.rc * K * L.wl * 4);  // row partials [rc, K, wl]
  L.fy = L.fx + (size_t)L.nk * W * 4;                       // gathered marginals
  L.total = L.fy + (size_t)L.nk * H * 4;
  return L;
}

// The sum over a warp of a[V] per lane, V = 4 or 8, in V - 1 + 5 - log2(V)
// shuffles: each level halves the values a lane keeps. Lane L ends with the
// sum of channel c = its bits 4, 3 (and 2 for V = 8), high to low.
template <int V>
__device__ __forceinline__ float warp_reduce_scatter(float* a, int lane, int& c) {
  c = 0;
  int bit = 16;
#pragma unroll
  for (int h = V / 2; h >= 1; h /= 2, bit >>= 1) {
    const bool up = lane & bit;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float send = up ? a[i] : a[i + h];
      const float keep = up ? a[i + h] : a[i];
      a[i] = keep + __shfl_xor_sync(0xffffffffu, send, bit);
    }
    c += up ? h : 0;
  }
  float v = a[0];
  for (; bit > 0; bit >>= 1) v += __shfl_xor_sync(0xffffffffu, v, bit);
  return v;
}

// One staged chunk of nr rows, 16-byte reads: every thread owns whole 16-byte
// column slots (their sums over the rows go into s_col), and a warp takes one
// (row, 16-byte channel group), its lanes striding over W, for the row's means.
template <typename T>
__device__ __forceinline__ void chunk_sums_vec(const T* x, int nr, int W, int K, float* s_col,
                                               float* s_rm) {
  constexpr int V = 16 / sizeof(T);
  const int WK = W * K;
  const int kv_count = K / V;
  for (int sl = threadIdx.x; sl < WK / V; sl += PH_THREADS) {
    float col[V] = {}, v[V];
    for (int r = 0; r < nr; ++r) {
      load_vec(x + (size_t)r * WK + sl * V, v);
#pragma unroll
      for (int j = 0; j < V; ++j) col[j] += v[j];
    }
#pragma unroll
    for (int j = 0; j < V; j += 4) {
      float4* p = reinterpret_cast<float4*>(s_col + sl * V + j);
      float4 q = *p;
      q.x += col[j];
      q.y += col[j + 1];
      q.z += col[j + 2];
      q.w += col[j + 3];
      *p = q;
    }
  }
  const int lane = threadIdx.x % 32;
  for (int t = threadIdx.x / 32; t < nr * kv_count; t += PH_WARPS) {
    const int r = t / kv_count;
    const int k0 = (t - r * kv_count) * V;
    float acc[V] = {}, v[V];
    for (int w = lane; w < W; w += 32) {
      load_vec(x + (size_t)r * WK + w * K + k0, v);
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] += v[j];
    }
    int c;
    const float sum = warp_reduce_scatter<V>(acc, lane, c);
    if ((lane & (32 / V - 1)) == 0) s_rm[r * K + k0 + c] = sum / (float)W;
  }
}

// The same sums element by element, for any W and K: thread (k, wl) owns the
// columns w = wl, wl + L.wl, ... of channel k and its share of each row's sum.
template <typename T>
__device__ __forceinline__ void chunk_sums_scalar(const T* x, int nr, int W, int K,
                                                  const PoseLayout& L, float* s_col,
                                                  float* s_part, float* s_rm) {
  const int WK = W * K;
  for (int idx = threadIdx.x; idx < K * L.wl; idx += PH_THREADS) {
    const int k = idx % K;
    const int wl = idx / K;
    float rowp[MAX_RC];
#pragma unroll
    for (int r = 0; r < MAX_RC; ++r) rowp[r] = 0.f;
    for (int w = wl; w < W; w += L.wl) {
      float col = 0.f;
#pragma unroll
      for (int r = 0; r < MAX_RC; ++r) {
        if (r < nr) {
          const float v = to_f32(x[(size_t)r * WK + w * K + k]);
          col += v;
          rowp[r] += v;
        }
      }
      s_col[w * K + k] += col;
    }
#pragma unroll
    for (int r = 0; r < MAX_RC; ++r)
      if (r < nr) s_part[(r * K + k) * L.wl + wl] = rowp[r];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < nr * K; idx += PH_THREADS) {
    const float* p = s_part + (size_t)idx * L.wl;
    float s = 0.f;
    for (int j = 0; j < L.wl; ++j) s += p[j];
    s_rm[idx] = s / (float)W;
  }
}

// p_out and q_out: the training form also writes both softmaxes, [B, K, W] and
// [B, K, H] (null in the inference form)
template <typename T, bool VEC>
__global__ void __launch_bounds__(PH_THREADS, 3)
pose_head_kernel(const T* __restrict__ raw, const float* __restrict__ gx,
                 const float* __restrict__ gy, float* __restrict__ out,
                 float* __restrict__ p_out, float* __restrict__ q_out, int H, int W, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const PoseLayout L = pose_layout(H, W, K, (int)sizeof(T), VEC);
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / CLUSTER;
  const int tid = threadIdx.x;
  const int WK = W * K;
  T* stage = reinterpret_cast<T*>(smem);
  float* s_col = reinterpret_cast<float*>(smem + L.col);
  float* s_rm = reinterpret_cast<float*>(smem + L.rm);
  float* s_part = reinterpret_cast<float*>(smem + L.part);
  float* s_fx = reinterpret_cast<float*>(smem + L.fx);
  float* s_fy = reinterpret_cast<float*>(smem + L.fy);

  const int row0 = rank * L.band;
  const int rows = max(0, min(L.band, H - row0));
  const int nchunks = (rows + L.rc - 1) / L.rc;
  const T* src = raw + ((size_t)b * H + row0) * WK;
  for (int i = tid; i < WK; i += PH_THREADS) s_col[i] = 0.f;

  // chunk c into buffer c % NSTAGE; one commit group a chunk, empty past the end
  auto load = [&](int c) {
    T* dst = stage + (size_t)(c % NSTAGE) * L.rc * WK;
    const int n = max(0, min(L.rc, rows - c * L.rc)) * WK;
    const T* g = src + (size_t)c * L.rc * WK;
    if (VEC) {
      constexpr int V = 16 / sizeof(T);
      for (int i = tid; i < n / V; i += PH_THREADS) cp_async16(dst + i * V, g + i * V);
    } else {
      for (int i = tid; i < n; i += PH_THREADS) dst[i] = g[i];
    }
    cp_async_commit();
  };

  for (int c = 0; c < NSTAGE - 1; ++c) load(c);
  for (int c = 0; c < nchunks; ++c) {
    load(c + NSTAGE - 1);
    cp_async_wait<NSTAGE - 1>();
    __syncthreads();
    const T* x = stage + (size_t)(c % NSTAGE) * L.rc * WK;
    const int nr = min(L.rc, rows - c * L.rc);
    if (VEC)
      chunk_sums_vec(x, nr, W, K, s_col, s_rm + c * L.rc * K);
    else
      chunk_sums_scalar(x, nr, W, K, L, s_col, s_part, s_rm + c * L.rc * K);
    __syncthreads();  // this buffer is the target of a copy the next iteration starts
  }

  // transpose this block's partials to channel-major into region A (free
  // now), so that a peer reads each channel's run of W (or band) floats in
  // whole 128-byte lines
  __syncthreads();  // s_col's zeros, where the band is empty
  float* t_col = reinterpret_cast<float*>(smem);  // [K, W]
  float* t_rm = t_col + (size_t)K * W;            // [K, band]
  for (int i = tid; i < WK; i += PH_THREADS) {
    const int k = i / W;
    t_col[i] = s_col[(i - k * W) * K + k];
  }
  for (int i = tid; i < rows * K; i += PH_THREADS) {
    const int k = i / rows;
    t_rm[k * L.band + i - k * rows] = s_rm[(i - k * rows) * K + k];
  }
  // gather the marginals of this block's channels [rank * nk, rank * nk + nk)
  // from the cluster: the W-marginal summed over the ranks in order, the
  // H-marginal from the rank that holds each row
  cluster.sync();
  const int kb = rank * L.nk;
  for (int i = tid; i < L.nk * W; i += PH_THREADS) {
    const int j = i / W;
    if (kb + j >= K) break;
    const size_t off = (size_t)(kb + j) * W + (i - j * W);
    float part[CLUSTER];
#pragma unroll
    for (int q = 0; q < CLUSTER; ++q) part[q] = cluster.map_shared_rank(t_col, q)[off];
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < CLUSTER; ++q) v += part[q];
    s_fx[i] = v / (float)H;
  }
  for (int i = tid; i < L.nk * H; i += PH_THREADS) {
    const int j = i / H;
    if (kb + j >= K) break;
    const int h = i - j * H;
    const int q = h / L.band;
    s_fy[i] = cluster.map_shared_rank(t_rm, q)[(size_t)(kb + j) * L.band + h - q * L.band];
  }
  // no peer reads this block's shared memory after this barrier, and the
  // gathered marginals are visible to the whole block
  cluster.sync();

  // both softmaxes, max-then-sum, one warp per (channel, axis)
  const int warp = tid / 32;
  const int lane = tid % 32;
  for (int task = warp; task < 2 * L.nk; task += PH_WARPS) {
    const int j = task >> 1;
    const int axis = task & 1;  // 0: x from the W-marginal, 1: y from the H-marginal
    const int k = kb + j;
    if (k >= K) continue;
    const int n = axis == 0 ? W : H;
    const float* m = axis == 0 ? s_fx + j * W : s_fy + j * H;
    const float* g = axis == 0 ? gx : gy;
    float mx = __int_as_float((int)0xff800000);  // -inf
    for (int i = lane; i < n; i += 32) mx = fmaxf(mx, m[i]);
    mx = warp_max(mx);
    float se = 0.f, sg = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float e = expf(m[i] - mx);
      se += e;
      sg += e * g[i];
    }
    se = warp_sum(se);
    sg = warp_sum(sg);
    if (lane == 0) out[((size_t)b * K + k) * 2 + axis] = sg / se;
    if (p_out != nullptr) {
      float* dst = (axis == 0 ? p_out : q_out) + ((size_t)b * K + k) * n;
      for (int i = lane; i < n; i += 32) dst[i] = expf(m[i] - mx) / se;
    }
  }
}

// a launch of `clusters` clusters of CLUSTER blocks of `threads` threads and
// `smem` bytes of shared memory each. The first launch at a larger `smem`
// than `checked` (the largest so far) raises the kernel's shared memory
// limit and checks that a cluster can be resident: one that cannot is
// refused with an error, and nothing else is launched in its place.
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kern)(Params...), size_t smem, size_t& checked,
                            unsigned clusters, int threads, cudaStream_t stream, Args... args) {
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(clusters * CLUSTER);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (smem > checked) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
    int resident = 0;
    e = cudaOccupancyMaxActiveClusters(&resident, kern, &cfg);
    if (e != cudaSuccess) return e;
    if (resident < 1) return cudaErrorLaunchOutOfResources;
    checked = smem;
  }
  cudaLaunchKernelEx(&cfg, kern, args...);
  return cudaGetLastError();
}

template <typename T, bool VEC>
cudaError_t launch_pose_head(const void* raw, const float* gx, const float* gy, float* out,
                             float* p, float* q, int B, int H, int W, int K,
                             cudaStream_t stream) {
  static size_t checked = 0;
  return launch_clusters(pose_head_kernel<T, VEC>,
                         pose_layout(H, W, K, (int)sizeof(T), VEC).total, checked, (unsigned)B,
                         PH_THREADS, stream, static_cast<const T*>(raw), gx, gy, out, p, q, H,
                         W, K);
}

__device__ __forceinline__ void store_vec(float* o, const float* v) {
  *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
}
// 8 f32 values rounded to bf16, as 16 bytes
__device__ __forceinline__ uint4 pack_bf16x8(const float* v) {
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    w[j] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* o, const float* v) {
  *reinterpret_cast<uint4*>(o) = pack_bf16x8(v);
}
__device__ __forceinline__ void store_one(float* o, float v) { *o = v; }
__device__ __forceinline__ void store_one(__nv_bfloat16* o, float v) { *o = __float2bfloat16_rn(v); }

// rows [nr, W, K] of the render's separable product out = a[r, k] * c[w, k],
// f32 arithmetic rounded once to T, along the contiguous NHWC rows in 16-byte
// vectors (VEC) or one element at a time
template <typename T, bool VEC>
__device__ __forceinline__ void write_separable(T* o, const float* a_rows, const float* c_cols,
                                                int nr, int W, int K) {
  const int tid = threadIdx.x;
  if (VEC) {
    constexpr int V = 16 / sizeof(T);
    const int kv = K / V;
    const int nvec = nr * W * kv;
    for (int i = tid; i < nvec; i += GR_THREADS) {
      const int p = i / kv;
      const int k0 = (i - p * kv) * V;
      const int r = p / W;
      const float* a = a_rows + r * K + k0;
      const float* c = c_cols + (p - r * W) * K + k0;
      float v[V];
#pragma unroll
      for (int j = 0; j < V; j += 4) {
        const float4 qa = *reinterpret_cast<const float4*>(a + j);
        const float4 qc = *reinterpret_cast<const float4*>(c + j);
        v[j] = qa.x * qc.x;
        v[j + 1] = qa.y * qc.y;
        v[j + 2] = qa.z * qc.z;
        v[j + 3] = qa.w * qc.w;
      }
      store_vec(o + (size_t)p * K + k0, v);
    }
  } else {
    for (int i = tid; i < nr * W * K; i += GR_THREADS) {
      const int p = i / K;
      const int k = i - p * K;
      const int r = p / W;
      const float a = a_rows[r * K + k];
      const float c = c_cols[(p - r * W) * K + k];
      store_one(o + i, a * c);
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(GR_THREADS)
gaussian_render_kernel(const float* __restrict__ mu, const float* __restrict__ gy,
                       const float* __restrict__ gx, T* __restrict__ out, int H, int W, int K,
                       int rb, int bands, float c2) {
  extern __shared__ __align__(16) float gsm[];
  const int n = blockIdx.x / bands;
  const int h0 = (blockIdx.x - n * bands) * rb;
  const int nr = min(rb, H - h0);
  const int tid = threadIdx.x;
  float* ey = gsm;           // [rb, K]
  float* ex = gsm + rb * K;  // [W, K]
  const float* m = mu + (size_t)n * K * 2;
  for (int i = tid; i < nr * K; i += GR_THREADS) {
    const float d = gy[h0 + i / K] - m[2 * (i % K) + 1];
    ey[i] = expf(-(d * d) * c2);
  }
  for (int i = tid; i < W * K; i += GR_THREADS) {
    const float d = gx[i / K] - m[2 * (i % K)];
    ex[i] = expf(-(d * d) * c2);
  }
  __syncthreads();
  write_separable<T, VEC>(out + ((size_t)n * H + h0) * W * K, ey, ex, nr, W, K);
}

// the row pitch, in floats, of the soft-argmax backward's staged terms: K
// rounded up to 4, an odd count of 16-byte units, so that 8 lanes storing 16
// bytes each at consecutive rows hit 8 distinct groups of banks
__host__ __device__ inline int pb_pitch(int K) {
  const int kp = (K + 3) / 4 * 4;
  return (kp / 4) % 2 ? kp : kp + 4;
}

// the H-marginal's terms of n rows, cy[i, k] = gp[2 k] q[k, i step] (grid[i step] -
// pt[2 k]) / div for i < n (q's rows at stride `ld`), into [n, KP], zero in
// the padding channels: a thread takes 4 channels of one row, lanes run along
// the rows over q, and the 16-byte stores transpose them
__device__ __forceinline__ void stage_row_terms(float* dst, int KP, const float* m, long ld,
                                                int step, int n, const float* grid,
                                                const float* gp, const float* pt, int K,
                                                float div) {
  const int nq = (K + 3) / 4;
  for (int t = threadIdx.x; t < nq * n; t += blockDim.x) {
    const int kq = t / n;
    const int r = t - kq * n;
    const int i = r * step;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 4 * kq + j;
      v[j] = k < K ? gp[2 * k] * m[k * ld + i] * (grid[i] - pt[2 * k]) / div : 0.f;
    }
    *reinterpret_cast<float4*>(dst + (size_t)r * KP + 4 * kq) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// 16 bytes (4 f32 or 8 bf16) or one element, stored with the evict-first
// (streaming) hint, so that L2 writes the lines back as they come
__device__ __forceinline__ void store_vec_cs(float* o, const float* v) {
  __stcs(reinterpret_cast<float4*>(o), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void store_vec_cs(__nv_bfloat16* o, const float* v) {
  __stcs(reinterpret_cast<uint4*>(o), pack_bf16x8(v));
}
__device__ __forceinline__ void store_one_cs(float* o, float v) { __stcs(o, v); }
__device__ __forceinline__ void store_one_cs(__nv_bfloat16* o, float v) {
  __stcs(reinterpret_cast<unsigned short*>(o), __bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

// g [B, K, 2] the points' cotangent, pts [B, K, 2] the forward's points, p
// [B, K, W] and q [B, K, H] its softmaxes -> the maps' gradient; block (b, j)
// of the G blocks of image b writes its rows j, j + G, j + 2 G, ...
template <typename T, bool VEC>
__global__ void __launch_bounds__(PB_THREADS, 1)
pose_head_backward_kernel(const float* __restrict__ g, const float* __restrict__ pts,
                          const float* __restrict__ p, const float* __restrict__ q,
                          const float* __restrict__ gy, const float* __restrict__ gx,
                          T* __restrict__ out, int H, int W, int K, int G) {
  constexpr int V = VEC ? 16 / sizeof(T) : 1;
  extern __shared__ __align__(16) float gsm[];
  const int KP = pb_pitch(K);
  float* cy = gsm;  // [PB_ROWS, KP]: the H-marginal's term of each row
  const int tid = threadIdx.x;
  const int kv = K / V;              // channel groups of a pixel
  const int cols = blockDim.x / kv;  // columns the threads take at once
  const int k0 = (tid % kv) * V;
  const int wc = tid / kv;
  const int b = blockIdx.x / G;
  const int j = blockIdx.x - b * G;
  const int n = (H - j + G - 1) / G;  // this block's rows
  const float* gb = g + (size_t)b * K * 2;
  const float* pb = pts + (size_t)b * K * 2;
  const float* pk = p + ((size_t)b * K + k0) * W;
  const size_t row_step = (size_t)G * W * K;  // elements from one of its rows to the next
  for (int i0 = 0; i0 < n; i0 += PB_ROWS) {
    const int nr = min(PB_ROWS, n - i0);
    const int h0 = j + G * i0;
    for (int c0 = 0; c0 < W; c0 += cols) {
      const int w = c0 + wc;
      const bool has = wc < cols && w < W;
      // this thread's column term, its loads in flight while cy is staged
      float pv[V], gv[V], tv[V], gw = 0.f;
      if (has) {
        gw = gx[w];
#pragma unroll
        for (int c = 0; c < V; ++c) {
          pv[c] = pk[(size_t)c * W + w];
          gv[c] = gb[2 * (k0 + c)];
          tv[c] = pb[2 * (k0 + c)];
        }
      }
      if (c0 == 0) {
        __syncthreads();  // the previous rows' reads of cy are done
        stage_row_terms(cy, KP, q + (size_t)b * K * H + h0, H, G, nr, gy + h0, gb + 1, pb + 1, K,
                        (float)W);
        __syncthreads();
      }
      if (has) {
        float cx[V];
#pragma unroll
        for (int c = 0; c < V; ++c) cx[c] = gv[c] * pv[c] * (gw - tv[c]) / (float)H;
        T* o = out + (((size_t)b * H + h0) * W + w) * K + k0;
#pragma unroll 4
        for (int r = 0; r < nr; ++r) {
          float v[V];
          load_f32v<V>(cy + r * KP + k0, v);
#pragma unroll
          for (int c = 0; c < V; ++c) v[c] += cx[c];
          if constexpr (VEC)
            store_vec_cs(o + r * row_step, v);
          else
            store_one_cs(o + r * row_step, v[0]);
        }
      }
    }
  }
}

// The render's backward shared memory, in floats: ey and ey (gy - my) of the
// band's rows [band, K] each, the threads' partials [wl, K, 2], and the sums
// of this block's share of the outputs that each rank sends it [CLUSTER,
// per]; total in bytes
struct RbLayout {
  int band;  // rows a block takes
  int kv;    // channel groups of a pixel
  int wl;    // columns the threads take at once
  int per;   // outputs a rank finishes
  size_t eyd, part, recv, total;
};

__host__ __device__ inline RbLayout rb_layout(int H, int W, int K, int V) {
  RbLayout L;
  L.band = (H + CLUSTER - 1) / CLUSTER;
  L.kv = K / V;
  L.wl = RB_THREADS / L.kv < W ? RB_THREADS / L.kv : W;
  L.per = (2 * K + CLUSTER - 1) / CLUSTER;
  L.eyd = (size_t)L.band * K;
  L.part = L.eyd + (size_t)L.band * K;
  L.recv = L.part + (size_t)L.wl * K * 2;
  L.total = (L.recv + (size_t)CLUSTER * L.per) * sizeof(float);
  return L;
}

// a cluster of CLUSTER blocks a frame: dmaps [N, H, W, K] -> dmu [N, K, 2]
template <typename T, bool VEC>
__global__ void __launch_bounds__(RB_THREADS)
render_backward_kernel(const T* __restrict__ dmaps, const float* __restrict__ mu,
                       const float* __restrict__ gy, const float* __restrict__ gx,
                       float* __restrict__ dmu, int H, int W, int K, float c2) {
  constexpr int V = VEC ? 16 / sizeof(T) : 1;
  extern __shared__ __align__(16) float rsm[];
  cg::cluster_group cluster = cg::this_cluster();
  // the first half of the barrier that makes sure every block of the cluster
  // runs before any writes to its shared memory (the wait comes later)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const RbLayout L = rb_layout(H, W, K, V);
  const int rank = (int)cluster.block_rank();
  const int n = blockIdx.x / CLUSTER;
  const int tid = threadIdx.x;
  const int row0 = rank * L.band;
  const int rows = max(0, min(L.band, H - row0));
  float* ey = rsm;
  float* eyd = rsm + L.eyd;
  float* part = rsm + L.part;
  float* recv = rsm + L.recv;
  const float* m = mu + (size_t)n * K * 2;
  // thread (w0, group): channels [k0, k0 + V) of the columns w0, w0 + wl, ...
  const bool active = tid < L.wl * L.kv;
  const int k0 = (tid % L.kv) * V;
  const int w0 = tid / L.kv;
  const size_t row_elems = (size_t)W * K;
  const T* src = dmaps + ((size_t)n * H + row0) * row_elems + k0;
  Raw<T, VEC> x[RB_RC];
  auto fetch = [&](int w, int r0) {
#pragma unroll
    for (int j = 0; j < RB_RC; ++j)
      if (r0 + j < rows) x[j].load(src + (size_t)(r0 + j) * row_elems + (size_t)w * K);
  };
  // the first slot's rows, the points' x and the first column's grid value
  // are in flight while the prologue runs
  float mx[V], gw0 = 0.f;
  if (active) {
    fetch(w0, 0);
#pragma unroll
    for (int j = 0; j < V; ++j) mx[j] = m[2 * (k0 + j)];
    gw0 = gx[w0];
  }
  for (int i = tid; i < rows * K; i += RB_THREADS) {
    const int r = i / K;
    const int k = i - r * K;
    const float d = gy[row0 + r] - m[2 * k + 1];
    const float e = expf(-(d * d) * c2);
    ey[i] = e;
    eyd[i] = e * d;
  }
  __syncthreads();
  if (active) {
    float px[V], py[V];
#pragma unroll
    for (int j = 0; j < V; ++j) px[j] = py[j] = 0.f;
    for (int w = w0; w < W; w += L.wl) {
      float a[V], ad[V];  // sum over the band's rows of G ey and of G ey (gy - my)
#pragma unroll
      for (int j = 0; j < V; ++j) a[j] = ad[j] = 0.f;
      for (int r0 = 0; r0 < rows; r0 += RB_RC) {
        if (w != w0 || r0 != 0) fetch(w, r0);
#pragma unroll
        for (int i = 0; i < RB_RC; ++i) {
          if (r0 + i < rows) {
            float v[V], e[V], ed[V];
            x[i].widen(v);
            load_f32v<V>(ey + (r0 + i) * K + k0, e);
            load_f32v<V>(eyd + (r0 + i) * K + k0, ed);
#pragma unroll
            for (int j = 0; j < V; ++j) {
              a[j] += v[j] * e[j];
              ad[j] += v[j] * ed[j];
            }
          }
        }
      }
      const float gw = w == w0 ? gw0 : gx[w];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float d = gw - mx[j];
        const float e = expf(-(d * d) * c2);
        px[j] += e * d * a[j];
        py[j] += e * ad[j];
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      part[(w0 * K + k0 + j) * 2] = px[j];
      part[(w0 * K + k0 + j) * 2 + 1] = py[j];
    }
  }
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  // rank r finishes the outputs [r per, (r + 1) per): this block's sum of
  // each output goes to its rank's shared memory, in the row of this rank
  for (int o = tid; o < 2 * K; o += RB_THREADS) {
    float s = 0.f;
    for (int j = 0; j < L.wl; ++j) s += part[j * 2 * K + o];
    const int owner = o / L.per;
    cluster.map_shared_rank(recv, owner)[rank * L.per + o - owner * L.per] = s;
  }
  // every rank's sums have arrived; no block touches another's shared memory
  // after this barrier, so a block may exit as soon as it is done
  cluster.sync();
  for (int i = tid; i < L.per && rank * L.per + i < 2 * K; i += RB_THREADS) {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < CLUSTER; ++r) s += recv[r * L.per + i];
    dmu[(size_t)n * 2 * K + rank * L.per + i] = 2.f * c2 * s;
  }
}

// the card's SM count, read once
cudaError_t sm_count(int* out) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  *out = sms;
  return cudaSuccess;
}

// rows a block of the render takes: about GR_BLOCKS_PER_SM blocks a SM
cudaError_t band_rows(long frames, int H, int* rb, int* bands) {
  int sms = 0;
  cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  const long rows = frames * H;
  const long target = (long)GR_BLOCKS_PER_SM * sms;
  int r = (int)((rows + target - 1) / target);
  r = r < 1 ? 1 : (r > H ? H : r);
  *rb = r;
  *bands = (H + r - 1) / r;
  return cudaSuccess;
}

// raise a kernel's dynamic shared memory limit to `smem` once it needs more
// than the default 48 KB; `attr_bytes` is that kernel's current limit
template <typename Kernel>
cudaError_t allow_smem(Kernel kern, size_t smem, size_t& attr_bytes) {
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  if (smem > attr_bytes) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
    attr_bytes = smem;
  }
  return cudaSuccess;
}

template <typename T, bool VEC>
cudaError_t launch_render(const float* mu, const float* gy, const float* gx, void* out, int N,
                          int H, int W, int K, float c2, cudaStream_t stream) {
  auto kern = gaussian_render_kernel<T, VEC>;
  int rb = 0, bands = 0;
  cudaError_t e = band_rows(N, H, &rb, &bands);
  if (e != cudaSuccess) return e;
  const size_t smem = (size_t)(rb + W) * K * sizeof(float);
  static size_t attr_bytes = 48 * 1024;
  e = allow_smem(kern, smem, attr_bytes);
  if (e != cudaSuccess) return e;
  kern<<<(unsigned)((long)N * bands), GR_THREADS, smem, stream>>>(
      mu, gy, gx, static_cast<T*>(out), H, W, K, rb, bands, c2);
  return cudaGetLastError();
}

template <typename T, bool VEC>
cudaError_t launch_pose_head_backward(const float* g, const float* pts, const float* p,
                                      const float* q, const float* gy, const float* gx,
                                      void* out, int B, int H, int W, int K,
                                      cudaStream_t stream) {
  auto kern = pose_head_backward_kernel<T, VEC>;
  constexpr int V = VEC ? 16 / sizeof(T) : 1;
  const int kv = K / V;
  if (kv > PB_THREADS) return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  // a thread for each (column, channel group) of a row, up to PB_THREADS
  const long slots = ((long)W * kv + 31) / 32 * 32;
  const int threads = slots < PB_THREADS ? (int)slots : PB_THREADS;
  // G blocks an image, at most a block a SM in all (a block an image past that)
  const int fit = B < sms ? sms / B : 1;
  const int G = fit < H ? fit : H;
  const int per = (H + G - 1) / G;
  const size_t smem = (size_t)(per < PB_ROWS ? per : PB_ROWS) * pb_pitch(K) * sizeof(float);
  static size_t attr_bytes = 48 * 1024;
  e = allow_smem(kern, smem, attr_bytes);
  if (e != cudaSuccess) return e;
  kern<<<(unsigned)((long)B * G), threads, smem, stream>>>(g, pts, p, q, gy, gx,
                                                           static_cast<T*>(out), H, W, K, G);
  return cudaGetLastError();
}

template <typename T, bool VEC>
cudaError_t launch_render_backward(const void* dmaps, const float* mu, const float* gy,
                                   const float* gx, float* dmu, int N, int H, int W, int K,
                                   float c2, cudaStream_t stream) {
  constexpr int V = VEC ? 16 / sizeof(T) : 1;
  if (K / V > RB_THREADS) return cudaErrorInvalidValue;
  static size_t checked = 0;
  return launch_clusters(render_backward_kernel<T, VEC>, rb_layout(H, W, K, V).total, checked,
                         (unsigned)N, RB_THREADS, stream, static_cast<const T*>(dmaps), mu, gy,
                         gx, dmu, H, W, K, c2);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 raw maps. p [B, K, W] and q [B, K, H]
// (f32): both null for the inference form, both set for the training form,
// which also writes the softmaxes for the backward. Returns the cudaError_t
// of the launch (0 on success).
int kpvid_pose_head(int dtype, const void* raw, const float* gx, const float* gy, float* out,
                    float* p, float* q, int B, int H, int W, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return cudaSuccess;
  if (H < 1 || W < 1 || K < 1 || (p == nullptr) != (q == nullptr)) return cudaErrorInvalidValue;
  // the 16-byte path reads 16-byte channel groups: K a multiple of 4 f32 or 8 bf16
  const bool aligned = reinterpret_cast<uintptr_t>(raw) % 16 == 0;
  if (dtype == 0) {
    const bool vec = aligned && K % 4 == 0;
    return vec ? launch_pose_head<float, true>(raw, gx, gy, out, p, q, B, H, W, K, s)
               : launch_pose_head<float, false>(raw, gx, gy, out, p, q, B, H, W, K, s);
  }
  if (dtype == 1) {
    const bool vec = aligned && K % 8 == 0;
    return vec ? launch_pose_head<__nv_bfloat16, true>(raw, gx, gy, out, p, q, B, H, W, K, s)
               : launch_pose_head<__nv_bfloat16, false>(raw, gx, gy, out, p, q, B, H, W, K, s);
  }
  return cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16 maps. gy [H] and gx [W] are the grid
// values, c2 = inv_std^2.
int kpvid_gaussian_render(int dtype, const float* mu, const float* gy, const float* gx,
                          void* out, int N, int H, int W, int K, float c2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N == 0) return cudaSuccess;
  if (H < 1 || W < 1 || K < 1) return cudaErrorInvalidValue;
  const bool aligned = reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (dtype == 0) {
    return aligned && K % 4 == 0
               ? launch_render<float, true>(mu, gy, gx, out, N, H, W, K, c2, s)
               : launch_render<float, false>(mu, gy, gx, out, N, H, W, K, c2, s);
  }
  if (dtype == 1) {
    return aligned && K % 8 == 0
               ? launch_render<__nv_bfloat16, true>(mu, gy, gx, out, N, H, W, K, c2, s)
               : launch_render<__nv_bfloat16, false>(mu, gy, gx, out, N, H, W, K, c2, s);
  }
  return cudaErrorInvalidValue;
}

// The soft-argmax's backward: dtype of the maps' gradient `out` [B, H, W, K]
// (0 = float32, 1 = bfloat16); g and pts [B, K, 2], p [B, K, W], q [B, K, H],
// gy [H], gx [W], all f32.
int kpvid_pose_head_backward(int dtype, const float* g, const float* pts, const float* p,
                             const float* q, const float* gy, const float* gx, void* out, int B,
                             int H, int W, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return cudaSuccess;
  if (H < 1 || W < 1 || K < 1) return cudaErrorInvalidValue;
  const bool aligned = reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (dtype == 0) {
    return aligned && K % 4 == 0
               ? launch_pose_head_backward<float, true>(g, pts, p, q, gy, gx, out, B, H, W, K, s)
               : launch_pose_head_backward<float, false>(g, pts, p, q, gy, gx, out, B, H, W, K,
                                                         s);
  }
  if (dtype == 1) {
    return aligned && K % 8 == 0
               ? launch_pose_head_backward<__nv_bfloat16, true>(g, pts, p, q, gy, gx, out, B, H,
                                                                W, K, s)
               : launch_pose_head_backward<__nv_bfloat16, false>(g, pts, p, q, gy, gx, out, B,
                                                                 H, W, K, s);
  }
  return cudaErrorInvalidValue;
}

// The render's backward: dtype of the maps' cotangent dmaps [N, H, W, K]
// (0 = float32, 1 = bfloat16) -> dmu [N, K, 2] f32, on the grid values gy
// [H], gx [W] and the c2 of the forward.
int kpvid_gaussian_render_backward(int dtype, const void* dmaps, const float* mu,
                                   const float* gy, const float* gx, float* dmu, int N, int H,
                                   int W, int K, float c2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N == 0) return cudaSuccess;
  if (H < 1 || W < 1 || K < 1) return cudaErrorInvalidValue;
  const bool aligned = reinterpret_cast<uintptr_t>(dmaps) % 16 == 0;
  if (dtype == 0) {
    return aligned && K % 4 == 0
               ? launch_render_backward<float, true>(dmaps, mu, gy, gx, dmu, N, H, W, K, c2, s)
               : launch_render_backward<float, false>(dmaps, mu, gy, gx, dmu, N, H, W, K, c2, s);
  }
  if (dtype == 1) {
    return aligned && K % 8 == 0
               ? launch_render_backward<__nv_bfloat16, true>(dmaps, mu, gy, gx, dmu, N, H, W, K,
                                                             c2, s)
               : launch_render_backward<__nv_bfloat16, false>(dmaps, mu, gy, gx, dmu, N, H, W,
                                                              K, c2, s);
  }
  return cudaErrorInvalidValue;
}

const char* kpvid_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
