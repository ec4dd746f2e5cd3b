// The encoders' inference conv bias + BN + ReLU in one pass, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves a ConvBNReLU's bias add, BN
// and ReLU to XLA's fusion of its jnp ops (kpvid_tpu/models/layers.py), with
// no pallas_call. In eager PyTorch the same arithmetic after cuDNN's conv was
// seven passes over the activation (models/layers.py: the bias add in the
// compute dtype, x.float(), - mean, * mul, + beta, .to(dtype), relu), 44
// bytes an element in bf16. This kernel does the same operations in the same
// order with the same roundings in one pass, so its output has the bits of
// those passes on this card:
//
//   t   = round_T(float(y) + float(bias))      bias: the conv bias in T
//   w   = ((float(t) - mean[c]) * mul[c]) + beta[c]   each step rounded to f32
//   out = round_T(w), then relu as torch.relu:  NaN stays, else fmaxf(v, 0)
//
// round_T is __float2bfloat16_rn for bf16 (the conversion PyTorch's
// c10::BFloat16 uses on sm_80 and later) and the identity for f32. The _rn
// intrinsics keep nvcc from contracting the sub, mul and add into an FMA,
// which would change bits. mul = weight * rsqrt(var + eps) comes from the
// caller's torch ops, so its bits do not depend on CUDA's rsqrtf.
//
// Bound on the card: bytes. The activation is read once and written once in
// T (4 bytes an element in bf16), plus the four [C] vectors. Design:
//   - 16-byte loads and stores (8 bf16 or 4 f32 channels) when C is a
//     multiple of the vector and both pointers are 16-byte aligned; the grid
//     is sized so that its stride in elements is a multiple of C, so a
//     thread's channels never change and it reads its bias, mean, mul and
//     beta once, into registers, before walking the activation;
//   - each thread keeps two vectors in flight (the grid holds about 8 blocks
//     of 256 threads a SM), the reads of y with the evict-first hint, since
//     nothing reads y again;
//   - any other C, unaligned pointers, or an activation whose channels are
//     its outer axis (NCHW in memory: cuDNN returns that layout for an input
//     that is, and the op keeps it, as the torch passes do) take a
//     one-element-a-thread kernel with the same arithmetic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NTHREADS = 256;
constexpr int BLOCKS_PER_SM = 8;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__device__ __forceinline__ T bias_bn_relu_one(T y, float bias, float mean, float mul, float beta,
                                              int relu) {
  const T t = narrow<T>(__fadd_rn(widen(y), bias));
  const float w = __fadd_rn(__fmul_rn(__fsub_rn(widen(t), mean), mul), beta);
  T out = narrow<T>(w);
  if (relu) {
    const float v = widen(out);
    if (!isnan(v)) out = narrow<T>(fmaxf(v, 0.0f));
  }
  return out;
}

template <typename T>
struct alignas(16) Vec {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

// y, out: [rows, C] as n_vec vectors of V = 16 / sizeof(T) channels; the
// launcher's grid stride (gridDim.x * NTHREADS * V) is a multiple of C.
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
bias_bn_relu_vec_kernel(const T* __restrict__ y, const T* __restrict__ bias,
                        const float* __restrict__ mean, const float* __restrict__ mul,
                        const float* __restrict__ beta, T* __restrict__ out, long long n_vec,
                        int C, int relu) {
  constexpr int V = Vec<T>::N;
  const long long stride = static_cast<long long>(gridDim.x) * NTHREADS;
  long long i = static_cast<long long>(blockIdx.x) * NTHREADS + threadIdx.x;
  if (i >= n_vec) return;
  const int c0 = static_cast<int>((i * V) % C);
  float b[V], m[V], s[V], be[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    b[j] = widen(bias[c0 + j]);
    m[j] = mean[c0 + j];
    s[j] = mul[c0 + j];
    be[j] = beta[c0 + j];
  }
  const uint4* src = reinterpret_cast<const uint4*>(y);
  uint4* dst = reinterpret_cast<uint4*>(out);
  for (; i < n_vec; i += 2 * stride) {
    const bool second = i + stride < n_vec;
    uint4 raw[2];
    raw[0] = __ldcs(src + i);
    if (second) raw[1] = __ldcs(src + i + stride);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (k == 1 && !second) break;
      Vec<T> x;
      *reinterpret_cast<uint4*>(&x) = raw[k];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        x.v[j] = bias_bn_relu_one(x.v[j], b[j], m[j], s[j], be[j], relu);
      }
      dst[i + k * stride] = *reinterpret_cast<uint4*>(&x);
    }
  }
}

// Element i of y and out is in channel (i / inner) % C: inner 1 for
// channels-last, H * W for channels-first.
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
bias_bn_relu_scalar_kernel(const T* __restrict__ y, const T* __restrict__ bias,
                           const float* __restrict__ mean, const float* __restrict__ mul,
                           const float* __restrict__ beta, T* __restrict__ out, long long n,
                           int C, long long inner, int relu) {
  const long long stride = static_cast<long long>(gridDim.x) * NTHREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * NTHREADS + threadIdx.x; i < n;
       i += stride) {
    const int c = static_cast<int>((i / inner) % C);
    out[i] = bias_bn_relu_one(y[i], widen(bias[c]), mean[c], mul[c], beta[c], relu);
  }
}

int gcd(int a, int b) {
  while (b) {
    const int r = a % b;
    a = b;
    b = r;
  }
  return a;
}

template <typename T>
int launch(const void* y, const void* bias, const float* mean, const float* mul,
           const float* beta, void* out, long long n, int C, long long inner, int relu,
           cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long cap = static_cast<long long>(sms) * BLOCKS_PER_SM;
  const T* yt = static_cast<const T*>(y);
  const T* bt = static_cast<const T*>(bias);
  T* ot = static_cast<T*>(out);
  constexpr int V = Vec<T>::N;
  const bool aligned =
      reinterpret_cast<uintptr_t>(y) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (inner == 1 && aligned && C % V == 0) {
    const long long n_vec = n / V;
    // blocks a multiple of q, so that blocks * NTHREADS * V is a multiple of C
    const int q = C / gcd(C, NTHREADS * V);
    long long blocks = (n_vec + NTHREADS - 1) / NTHREADS;
    if (blocks > cap) blocks = cap;
    blocks = (blocks + q - 1) / q * q;
    bias_bn_relu_vec_kernel<T><<<static_cast<unsigned>(blocks), NTHREADS, 0, s>>>(
        yt, bt, mean, mul, beta, ot, n_vec, C, relu);
  } else {
    long long blocks = (n + NTHREADS - 1) / NTHREADS;
    if (blocks > cap) blocks = cap;
    bias_bn_relu_scalar_kernel<T><<<static_cast<unsigned>(blocks), NTHREADS, 0, s>>>(
        yt, bt, mean, mul, beta, ot, n, C, inner, relu);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 for y, bias and out; y and out n dense
// elements in one layout, element i in channel (i / inner) % C (inner 1:
// channels-last; H * W: channels-first), mean, mul and beta [C] f32.
// Returns the cudaError_t of the launch (0 on success).
int kpvid_bias_bn_relu(int dtype, const void* y, const void* bias, const float* mean,
                       const float* mul, const float* beta, void* out, long long n, int C,
                       long long inner, int relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C < 1 || inner < 1 || n < 0 || n % (C * inner)) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  if (dtype == 0) return launch<float>(y, bias, mean, mul, beta, out, n, C, inner, relu, s);
  if (dtype == 1) {
    return launch<__nv_bfloat16>(y, bias, mean, mul, beta, out, n, C, inner, relu, s);
  }
  return cudaErrorInvalidValue;
}

const char* kpvid_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
