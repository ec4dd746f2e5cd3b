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
// reads no map: it is the render's separable write with a sum in place of the
// product. Bound: the gradient's bytes, written once (41.9 MB in bf16 at
// [32, 128, 128, 40], 12.5 us at 3.35 TB/s). Same bands of rows per block.
//
// gaussian_render_backward: d mu_x[n, k] = 2 c2 sum_{h,w} G ey_h ex_w (gx_w -
// mu_x), d mu_y likewise with (gy_h - mu_y), from the maps' cotangent G in
// the maps' dtype, widened to f32. One block takes one frame: it recomputes ey
// and ex into shared memory, each thread owns one 16-byte channel group (4 f32
// or 8 bf16 channels) and a fixed stride of pixels, and the threads' partial
// sums are added in a fixed order, with no atomics, so a rerun gives the same
// bits. Bound: one read of G (1.3 MB in bf16 at [16, 32, 32, 40]); with one
// block a frame it is latency-bound at the training shape.

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
constexpr int RB_THREADS = 512;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// V f32 values from 16 bytes of shared memory (4 f32 or 8 bf16)
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

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

template <typename T, bool VEC>
cudaError_t launch_pose_head(const void* raw, const float* gx, const float* gy, float* out,
                             float* p, float* q, int B, int H, int W, int K,
                             cudaStream_t stream) {
  auto kern = pose_head_kernel<T, VEC>;
  const PoseLayout L = pose_layout(H, W, K, (int)sizeof(T), VEC);
  if (L.total > MAX_SMEM) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3((unsigned)(B * CLUSTER));
  cfg.blockDim = dim3(PH_THREADS);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // the largest shared memory this instantiation has been set up and checked
  // for: a cluster whose blocks cannot be resident together is refused here
  static size_t checked = 0;
  if (L.total > checked) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.total);
    if (e != cudaSuccess) return e;
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
    if (e != cudaSuccess) return e;
    if (clusters < 1) return cudaErrorLaunchOutOfResources;
    checked = L.total;
  }
  cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(raw), gx, gy, out, p, q, H, W, K);
  return cudaGetLastError();
}

__device__ __forceinline__ void store_vec(float* o, const float* v) {
  *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* o, const float* v) {
  uint4 q;
  __nv_bfloat162 h[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  q.x = *reinterpret_cast<uint32_t*>(&h[0]);
  q.y = *reinterpret_cast<uint32_t*>(&h[1]);
  q.z = *reinterpret_cast<uint32_t*>(&h[2]);
  q.w = *reinterpret_cast<uint32_t*>(&h[3]);
  *reinterpret_cast<uint4*>(o) = q;
}
__device__ __forceinline__ void store_one(float* o, float v) { *o = v; }
__device__ __forceinline__ void store_one(__nv_bfloat16* o, float v) { *o = __float2bfloat16_rn(v); }

// rows [nr, W, K] of a separable function of (row, column): out = a[r, k] *
// c[w, k] (the render) or a[r, k] + c[w, k] (the soft-argmax's gradient), f32
// arithmetic rounded once to T, along the contiguous NHWC rows in 16-byte
// vectors (VEC) or one element at a time
template <typename T, bool VEC, bool SUM>
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
        v[j] = SUM ? qa.x + qc.x : qa.x * qc.x;
        v[j + 1] = SUM ? qa.y + qc.y : qa.y * qc.y;
        v[j + 2] = SUM ? qa.z + qc.z : qa.z * qc.z;
        v[j + 3] = SUM ? qa.w + qc.w : qa.w * qc.w;
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
      store_one(o + i, SUM ? a + c : a * c);
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
  write_separable<T, VEC, false>(out + ((size_t)n * H + h0) * W * K, ey, ex, nr, W, K);
}

// g [B, K, 2] the points' cotangent, pts [B, K, 2] the forward's points, p
// [B, K, W] and q [B, K, H] its softmaxes -> the maps' gradient, a band of rb
// rows of one image per block
template <typename T, bool VEC>
__global__ void __launch_bounds__(GR_THREADS)
pose_head_backward_kernel(const float* __restrict__ g, const float* __restrict__ pts,
                          const float* __restrict__ p, const float* __restrict__ q,
                          const float* __restrict__ gy, const float* __restrict__ gx,
                          T* __restrict__ out, int H, int W, int K, int rb, int bands) {
  extern __shared__ __align__(16) float gsm[];
  const int b = blockIdx.x / bands;
  const int h0 = (blockIdx.x - b * bands) * rb;
  const int nr = min(rb, H - h0);
  const int tid = threadIdx.x;
  float* cy = gsm;           // [rb, K]: the H-marginal's term of each row
  float* cx = gsm + rb * K;  // [W, K]: the W-marginal's term of each column
  const float* gb = g + (size_t)b * K * 2;
  const float* pb = pts + (size_t)b * K * 2;
  for (int i = tid; i < nr * K; i += GR_THREADS) {
    const int r = i / K;
    const int k = i - r * K;
    const int h = h0 + r;
    cy[i] = gb[2 * k + 1] * q[((size_t)b * K + k) * H + h] * (gy[h] - pb[2 * k + 1]) / (float)W;
  }
  for (int i = tid; i < W * K; i += GR_THREADS) {
    const int w = i / K;
    const int k = i - w * K;
    cx[i] = gb[2 * k] * p[((size_t)b * K + k) * W + w] * (gx[w] - pb[2 * k]) / (float)H;
  }
  __syncthreads();
  write_separable<T, VEC, true>(out + ((size_t)b * H + h0) * W * K, cy, cx, nr, W, K);
}

// one block a frame: dmaps [N, H, W, K] -> dmu [N, K, 2]
template <typename T, bool VEC>
__global__ void __launch_bounds__(RB_THREADS)
render_backward_kernel(const T* __restrict__ dmaps, const float* __restrict__ mu,
                       const float* __restrict__ gy, const float* __restrict__ gx,
                       float* __restrict__ dmu, int H, int W, int K, float c2) {
  constexpr int V = VEC ? 16 / sizeof(T) : 1;
  extern __shared__ __align__(16) float rsm[];
  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int kv = K / V;            // channel groups of a pixel
  const int ng = RB_THREADS / kv;  // threads that share a channel group
  float* ey = rsm;                 // [H, K]
  float* ex = ey + H * K;          // [W, K]
  float* part = ex + W * K;        // [ng, K, 2]: each thread's sums
  const float* m = mu + (size_t)n * K * 2;
  for (int i = tid; i < H * K; i += RB_THREADS) {
    const float d = gy[i / K] - m[2 * (i % K) + 1];
    ey[i] = expf(-(d * d) * c2);
  }
  for (int i = tid; i < W * K; i += RB_THREADS) {
    const float d = gx[i / K] - m[2 * (i % K)];
    ex[i] = expf(-(d * d) * c2);
  }
  __syncthreads();
  if (tid < ng * kv) {
    const int k0 = (tid % kv) * V;
    const int g0 = tid / kv;
    float mx[V], my[V], ax[V], ay[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      mx[j] = m[2 * (k0 + j)];
      my[j] = m[2 * (k0 + j) + 1];
      ax[j] = 0.f;
      ay[j] = 0.f;
    }
    const T* src = dmaps + (size_t)n * H * W * K + k0;
    for (int pix = g0; pix < H * W; pix += ng) {
      const int h = pix / W;
      const int w = pix - h * W;
      float v[V];
      if constexpr (VEC)
        load_vec(src + (size_t)pix * K, v);
      else
        v[0] = to_f32(src[(size_t)pix * K]);
      const float* a = ey + h * K + k0;
      const float* c = ex + w * K + k0;
      const float dy = gy[h];
      const float dx = gx[w];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float t = v[j] * a[j] * c[j];
        ax[j] += t * (dx - mx[j]);
        ay[j] += t * (dy - my[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      part[(g0 * K + k0 + j) * 2] = ax[j];
      part[(g0 * K + k0 + j) * 2 + 1] = ay[j];
    }
  }
  __syncthreads();
  for (int i = tid; i < 2 * K; i += RB_THREADS) {
    float s = 0.f;
    for (int j = 0; j < ng; ++j) s += part[j * 2 * K + i];
    dmu[(size_t)n * 2 * K + i] = 2.f * c2 * s;
  }
}

// rows a block of the band kernels takes: about GR_BLOCKS_PER_SM blocks a SM
cudaError_t band_rows(long frames, int H, int* rb, int* bands) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
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
  int rb = 0, bands = 0;
  cudaError_t e = band_rows(B, H, &rb, &bands);
  if (e != cudaSuccess) return e;
  const size_t smem = (size_t)(rb + W) * K * sizeof(float);
  static size_t attr_bytes = 48 * 1024;
  e = allow_smem(kern, smem, attr_bytes);
  if (e != cudaSuccess) return e;
  kern<<<(unsigned)((long)B * bands), GR_THREADS, smem, stream>>>(
      g, pts, p, q, gy, gx, static_cast<T*>(out), H, W, K, rb, bands);
  return cudaGetLastError();
}

template <typename T, bool VEC>
cudaError_t launch_render_backward(const void* dmaps, const float* mu, const float* gy,
                                   const float* gx, float* dmu, int N, int H, int W, int K,
                                   float c2, cudaStream_t stream) {
  auto kern = render_backward_kernel<T, VEC>;
  constexpr int V = VEC ? 16 / sizeof(T) : 1;
  const int kv = K / V;
  if (kv < 1 || kv > RB_THREADS) return cudaErrorInvalidValue;
  const int ng = RB_THREADS / kv;
  const size_t smem = ((size_t)(H + W) * K + (size_t)ng * K * 2) * sizeof(float);
  static size_t attr_bytes = 48 * 1024;
  cudaError_t e = allow_smem(kern, smem, attr_bytes);
  if (e != cudaSuccess) return e;
  kern<<<(unsigned)N, RB_THREADS, smem, stream>>>(static_cast<const T*>(dmaps), mu, gy, gx, dmu,
                                                 H, W, K, c2);
  return cudaGetLastError();
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
