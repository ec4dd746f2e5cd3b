// Fused 3x3 SAME conv + per-channel affine (folded BN / bias) + optional ReLU,
// NHWC activations, HWIO weights, f32 accumulation, for Hopper (sm_90a).
//
// Replaces two TPU kernels of kpvid_tpu/ops/pallas_conv.py:
//   conv3x3_affine    (pl.pallas_call at pallas_conv.py:158)
//   up2_conv3_affine  (pl.pallas_call at pallas_conv.py:434)
// and, with an f32 addend read in the epilogue (conv3x3_add_affine, #1+), the
// translator's split first conv with oct0a's BN + ReLU, which the JAX path
// leaves to XLA (conv3x3_mma.cuh says more).
// The second is the same kernel with another input loader: it builds the
// TF1-legacy 2x upsample of x (out[2i] = x[i], out[2i+1] = (x[i] + x[i+1]) / 2,
// edge-clamped) straight into the shared-memory halo tile, so it is exact on
// every border without the TPU kernel's phase decomposition or border splices.
//
// Bound on the card: at the translator's shapes the work is 2 * 9 * C * Cout
// flops per output pixel against a few bytes per pixel, far above the bf16
// ridge point, so the bound is operations. Two routes:
//   - bfloat16, the serving path: an implicit GEMM on the tensor cores
//     (conv3x3_mma.cuh);
//   - float32, for the parity checks: the CUDA-core kernel below. TF32 tensor
//     cores would round the inputs to 10 mantissa bits, which the f32 checks
//     (rtol 1e-4) do not allow. One block computes a TH x TW tile of output
//     pixels times TCO output channels; for each chunk of CI input channels it
//     stages the (TH+2) x (TW+2) input halo and the 3 x 3 x CI x TCO weight
//     slice in shared memory, then every thread accumulates PX pixels x CO_T
//     channels with FMAs.

#include <cuda_runtime.h>

#include "conv3x3_mma.cuh"

namespace {

constexpr int TH = 16;
constexpr int TW = 16;
constexpr int CI = 16;
constexpr int NTHREADS = 256;
constexpr int HALO = (TH + 2) * (TW + 2);

// x: [N, H, W, C]; w: [3, 3, C, Cout]; out: [N, OH, OW, Cout] with
// (OH, OW) = (H, W), or (2H, 2W) when UP2 (the conv then runs on the
// upsampled input). add: null, or (not UP2) the f32 addend [N / frames, OH,
// OW, Cout] added to the conv before the affine.
template <int TCO, int CO_T, int PX, bool UP2>
__global__ void __launch_bounds__(NTHREADS)
conv3x3_affine_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ add, int frames,
                      const float* __restrict__ scale, const float* __restrict__ shift,
                      float* __restrict__ out, int H, int W, int C, int Cout, int OH, int OW,
                      int tiles_w, int tiles_per_img, int relu) {
  static_assert((TH * TW / PX) * (TCO / CO_T) == NTHREADS, "thread layout");
  constexpr int NPG = TH * TW / PX;  // pixel groups; thread t owns pixels pg + p * NPG
  extern __shared__ float smem[];
  float* s_in = smem;               // [CI][TH + 2][TW + 2]
  float* s_w = smem + CI * HALO;    // [CI][9][TCO]

  const int tid = threadIdx.x;
  const int n = blockIdx.x / tiles_per_img;
  const int tile = blockIdx.x - n * tiles_per_img;
  const int oy0 = (tile / tiles_w) * TH;
  const int ox0 = (tile % tiles_w) * TW;
  const int co0 = blockIdx.y * TCO;
  const int pg = tid % NPG;
  const int cg = tid / NPG;
  const float* xn = x + (size_t)n * H * W * C;

  float acc[PX][CO_T];
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int j = 0; j < CO_T; ++j) acc[p][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CI) {
    for (int i = tid; i < CI * HALO; i += NTHREADS) {
      const int ci = i % CI;
      const int pix = i / CI;
      const int r = pix / (TW + 2);
      const int cc = pix - r * (TW + 2);
      const int gy = oy0 - 1 + r;
      const int gx = ox0 - 1 + cc;
      const int c = c0 + ci;
      float v = 0.f;
      if (c < C && gy >= 0 && gy < OH && gx >= 0 && gx < OW) {
        if (!UP2) {
          v = xn[((size_t)gy * W + gx) * C + c];
        } else {
          // upsample along H first, then along W (the order of
          // ops/resize.py::upsample2x), in f32
          const int r0 = gy >> 1, q0 = gx >> 1;
          const int r1 = min(r0 + 1, H - 1), q1 = min(q0 + 1, W - 1);
          float a = xn[((size_t)r0 * W + q0) * C + c];
          if (gy & 1) a = (a + xn[((size_t)r1 * W + q0) * C + c]) * 0.5f;
          if (gx & 1) {
            float b = xn[((size_t)r0 * W + q1) * C + c];
            if (gy & 1) b = (b + xn[((size_t)r1 * W + q1) * C + c]) * 0.5f;
            a = (a + b) * 0.5f;
          }
          v = a;
        }
      }
      s_in[(ci * (TH + 2) + r) * (TW + 2) + cc] = v;
    }
    for (int i = tid; i < CI * 9 * TCO; i += NTHREADS) {
      const int co = i % TCO;
      const int rest = i / TCO;
      const int ci = rest % CI;
      const int tap = rest / CI;
      const int c = c0 + ci;
      const int o = co0 + co;
      float v = 0.f;
      if (c < C && o < Cout) v = w[((size_t)tap * C + c) * Cout + o];
      s_w[(ci * 9 + tap) * TCO + co] = v;
    }
    __syncthreads();

#pragma unroll 2
    for (int ci = 0; ci < CI; ++ci) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          float wv[CO_T];
          const float* wp = s_w + (ci * 9 + dy * 3 + dx) * TCO + cg * CO_T;
#pragma unroll
          for (int j = 0; j < CO_T; j += 4) {
            const float4 q = *reinterpret_cast<const float4*>(wp + j);
            wv[j] = q.x;
            wv[j + 1] = q.y;
            wv[j + 2] = q.z;
            wv[j + 3] = q.w;
          }
#pragma unroll
          for (int p = 0; p < PX; ++p) {
            const int pix = pg + p * NPG;
            const int py = pix / TW;
            const int px = pix - py * TW;
            const float iv = s_in[(ci * (TH + 2) + py + dy) * (TW + 2) + px + dx];
#pragma unroll
            for (int j = 0; j < CO_T; ++j) acc[p][j] = fmaf(iv, wv[j], acc[p][j]);
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int p = 0; p < PX; ++p) {
    const int pix = pg + p * NPG;
    const int oy = oy0 + pix / TW;
    const int ox = ox0 + pix % TW;
    if (oy >= OH || ox >= OW) continue;
    float* op = out + (((size_t)n * OH + oy) * OW + ox) * Cout;
    const float* ap = add ? add + (((size_t)(n / frames) * OH + oy) * OW + ox) * Cout : nullptr;
#pragma unroll
    for (int j = 0; j < CO_T; ++j) {
      const int o = co0 + cg * CO_T + j;
      if (o < Cout) {
        float y = (ap ? acc[p][j] + ap[o] : acc[p][j]) * scale[o] + shift[o];
        if (relu) y = fmaxf(y, 0.f);
        op[o] = y;
      }
    }
  }
}

template <int TCO, int CO_T, int PX, bool UP2>
cudaError_t launch(const float* x, const float* w, const float* add, int frames,
                   const float* scale, const float* shift, float* out, int N, int H, int W, int C,
                   int Cout, int relu, cudaStream_t stream) {
  auto kern = conv3x3_affine_kernel<TCO, CO_T, PX, UP2>;
  const size_t smem = (size_t)(CI * HALO + CI * 9 * TCO) * sizeof(float);
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int OH = UP2 ? 2 * H : H;
  const int OW = UP2 ? 2 * W : W;
  const int tiles_w = (OW + TW - 1) / TW;
  const int tiles_per_img = ((OH + TH - 1) / TH) * tiles_w;
  dim3 grid((unsigned)(N * tiles_per_img), (unsigned)((Cout + TCO - 1) / TCO));
  kern<<<grid, NTHREADS, smem, stream>>>(x, w, add, frames, scale, shift, out, H, W, C, Cout, OH,
                                         OW, tiles_w, tiles_per_img, relu);
  return cudaGetLastError();
}

template <bool UP2>
cudaError_t dispatch_width(const float* x, const float* w, const float* add, int frames,
                           const float* scale, const float* shift, float* out, int N, int H,
                           int W, int C, int Cout, int relu, cudaStream_t stream) {
  // wide layers: 64 output channels a block, 4 pixels x 16 channels a thread;
  // narrow ones (the 4-channel crude+mask head): 4 channels, 1 pixel a thread
  if (Cout >= 64)
    return launch<64, 16, 4, UP2>(x, w, add, frames, scale, shift, out, N, H, W, C, Cout, relu,
                                  stream);
  return launch<4, 4, 1, UP2>(x, w, add, frames, scale, shift, out, N, H, W, C, Cout, relu,
                              stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores). up2: 0 =
// conv3x3_affine, 1 = up2_conv3_affine. add: null, or (with up2 = 0, for
// conv3x3_add_affine) the f32 addend [N / frames, H, W, Cout], whose row n /
// frames is added to output image n before the affine. Returns the
// cudaError_t of the launch (0 on success).
int kpvid_conv3x3_affine(int dtype, int up2, const void* x, const void* w, const float* add,
                         int frames, const float* scale, const float* shift, void* out, int N,
                         int H, int W, int C, int Cout, int relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (add && (up2 || frames <= 0 || N % frames != 0)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    auto xf = static_cast<const float*>(x);
    auto wf = static_cast<const float*>(w);
    auto of = static_cast<float*>(out);
    return up2 ? dispatch_width<true>(xf, wf, add, frames, scale, shift, of, N, H, W, C, Cout,
                                      relu, s)
               : dispatch_width<false>(xf, wf, add, frames, scale, shift, of, N, H, W, C, Cout,
                                       relu, s);
  }
  if (dtype == 1)
    return kpvid_mma::conv3x3_bf16(up2, x, w, add, frames, scale, shift, out, N, H, W, C, Cout,
                                   relu, s);
  return (int)cudaErrorInvalidValue;
}

const char* kpvid_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
