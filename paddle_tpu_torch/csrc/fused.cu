// RMSNorm and SwiGLU forward for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/fused.py `_rms_kernel` (reached through
// `_rms_fwd_pallas`; entry `pt_rms_norm_fwd`) and fused.py `_swiglu_kernel`
// (reached through `_swiglu_fwd_pallas`; entry `pt_swiglu_fwd`). Same
// functions:
//
//   rms_norm  y = round_T((x_f * rsqrt(sum(x_f^2) / H + eps)) * w_f)
//   swiglu    y = round_TX(silu(x_f) * g_f),  silu(x) = x / (1 + expf(-x))
//
// with every intermediate in fp32 and one rounding to x's type at the end.
// x may be float, bf16 or fp16; the RMSNorm weight is in x's type or float,
// the SwiGLU gate in any of the three. The TPU kernels' row blocks
// (`_row_block`) are a VMEM tiling with no meaning here.
//
// What bounds them on the H100: both do a handful of fp32 operations per
// element and move every element once, so device memory. At the fused-op
// path shape (8192 tokens, Llama-2-7B widths, bf16) RMSNorm moves 134 MB
// ([8192, 4096] in and out; 40 us at 3.35 TB/s) and SwiGLU 541 MB (two
// [8192, 11008] halves in, one out; 161 us). What the design does about it:
// one read and one write per element from device memory, in 16-byte
// accesses where the row length and the pointers allow it, neighbouring
// threads on neighbouring addresses, and no scratch in device memory.
//
// - RMSNorm: one block of 256 threads per row. A first pass sums x^2 in
//   fp32 (per thread, then warp shuffles, then one pass over the eight
//   warps' partial sums in shared memory); a second pass reads the row
//   again (8 KB at H = 4096 bf16, still in L1/L2, not device memory),
//   scales it and writes it. The weight is read per element, from L2.
// - SwiGLU: x and g each have their own row stride, so the split form
//   (`swiglu(x)` with x [N, 2F]) reads both halves of x in place: stride 2F,
//   g at offset F. Blocks cover 256 vectors of a row (grid x) and rows
//   (grid y, striding past 65535 rows).
//
// Each entry launches on `stream`, allocates nothing, does not synchronise,
// and returns cudaGetLastError() (cudaErrorInvalidValue for a type it does
// not take).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace pt_fused {

constexpr int NT = 256;  // threads per block
enum TypeCode { F32 = 0, BF16 = 1, F16 = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// V elements of T moved as one access of V * sizeof(T) bytes.
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, typename W, int V>
__global__ void __launch_bounds__(NT)
    rms_norm_kernel(const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ y, int h,
                    float eps) {
  using VT = Vec<T, V>;
  const size_t row = blockIdx.x;
  const VT* xr = reinterpret_cast<const VT*>(x + row * h);
  VT* yr = reinterpret_cast<VT*>(y + row * h);
  const int nv = h / V;  // V divides h

  float ss = 0.f;
  for (int i = threadIdx.x; i < nv; i += NT) {
    const VT a = xr[i];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float f = to_f(a.v[j]);
      ss += f * f;
    }
  }
  __shared__ float part[NT / 32];
  __shared__ float r_sh;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x < 32) {
    float s = threadIdx.x < NT / 32 ? part[threadIdx.x] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (threadIdx.x == 0) r_sh = rsqrtf(s / (float)h + eps);
  }
  __syncthreads();
  const float r = r_sh;

  for (int i = threadIdx.x; i < nv; i += NT) {
    const VT a = xr[i];
    VT out;
#pragma unroll
    for (int j = 0; j < V; ++j) out.v[j] = from_f<T>((to_f(a.v[j]) * r) * to_f(w[i * V + j]));
    yr[i] = out;
  }
}

template <typename TX, typename TG, int V>
__global__ void __launch_bounds__(NT)
    swiglu_kernel(const TX* __restrict__ x, const TG* __restrict__ g, TX* __restrict__ y, int n,
                  int f, long long sx, long long sg) {
  const int col = blockIdx.x * NT + threadIdx.x;  // vector index within a row
  if (col >= f / V) return;
  for (long long row = blockIdx.y; row < n; row += gridDim.y) {
    const Vec<TX, V> a = reinterpret_cast<const Vec<TX, V>*>(x + row * sx)[col];
    const Vec<TG, V> b = reinterpret_cast<const Vec<TG, V>*>(g + row * sg)[col];
    Vec<TX, V> out;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float xf = to_f(a.v[j]);
      out.v[j] = from_f<TX>(xf / (1.f + expf(-xf)) * to_f(b.v[j]));
    }
    reinterpret_cast<Vec<TX, V>*>(y + row * (long long)f)[col] = out;
  }
}

inline bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T, typename W>
cudaError_t rms_norm(const void* x, const void* w, void* y, int n, int h, float eps,
                     cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (h % V == 0 && aligned(x, 16) && aligned(y, 16)) {
    rms_norm_kernel<T, W, V><<<n, NT, 0, stream>>>((const T*)x, (const W*)w, (T*)y, h, eps);
  } else {
    rms_norm_kernel<T, W, 1><<<n, NT, 0, stream>>>((const T*)x, (const W*)w, (T*)y, h, eps);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t rms_norm_w(int w_type, const void* x, const void* w, void* y, int n, int h,
                       float eps, cudaStream_t stream) {
  if (w_type == F32) return rms_norm<T, float>(x, w, y, n, h, eps, stream);
  return cudaErrorInvalidValue;
}

template <typename TX, typename TG>
cudaError_t swiglu(const void* x, const void* g, void* y, int n, int f, long long sx,
                   long long sg, cudaStream_t stream) {
  constexpr int V = 16 / (sizeof(TX) > sizeof(TG) ? sizeof(TX) : sizeof(TG));
  const bool vec = f % V == 0 && sx % V == 0 && sg % V == 0 && aligned(x, sizeof(TX) * V) &&
                   aligned(y, sizeof(TX) * V) && aligned(g, sizeof(TG) * V);
  const int per_row = vec ? f / V : f;
  const dim3 grid((per_row + NT - 1) / NT, n < 65535 ? n : 65535);
  if (vec) {
    swiglu_kernel<TX, TG, V><<<grid, NT, 0, stream>>>((const TX*)x, (const TG*)g, (TX*)y, n, f,
                                                      sx, sg);
  } else {
    swiglu_kernel<TX, TG, 1><<<grid, NT, 0, stream>>>((const TX*)x, (const TG*)g, (TX*)y, n, f,
                                                      sx, sg);
  }
  return cudaGetLastError();
}

template <typename TX>
cudaError_t swiglu_g(int g_type, const void* x, const void* g, void* y, int n, int f,
                     long long sx, long long sg, cudaStream_t stream) {
  switch (g_type) {
    case F32: return swiglu<TX, float>(x, g, y, n, f, sx, sg, stream);
    case BF16: return swiglu<TX, __nv_bfloat16>(x, g, y, n, f, sx, sg, stream);
    case F16: return swiglu<TX, __half>(x, g, y, n, f, sx, sg, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace pt_fused

// x, y [n, h] contiguous in the io type (x_type: 0 float, 1 bf16, 2 fp16);
// w [h] contiguous, in x's type or float (w_type). Launches on `stream` and
// returns cudaGetLastError().
extern "C" int pt_rms_norm_fwd(const void* x, const void* w, void* y, int n, int h, float eps,
                               int x_type, int w_type, void* stream) {
  using namespace pt_fused;
  const cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || h <= 0) return (int)cudaErrorInvalidValue;
  switch (x_type) {
    case F32:
      return (int)rms_norm_w<float>(w_type, x, w, y, n, h, eps, s);
    case BF16:
      if (w_type == BF16) return (int)rms_norm<__nv_bfloat16, __nv_bfloat16>(x, w, y, n, h, eps, s);
      return (int)rms_norm_w<__nv_bfloat16>(w_type, x, w, y, n, h, eps, s);
    case F16:
      if (w_type == F16) return (int)rms_norm<__half, __half>(x, w, y, n, h, eps, s);
      return (int)rms_norm_w<__half>(w_type, x, w, y, n, h, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Element (i, j) of x is x[i * sx + j], of g g[i * sg + j] (i < n, j < f);
// y [n, f] contiguous in x's type. x_type and g_type: 0 float, 1 bf16,
// 2 fp16. Launches on `stream` and returns cudaGetLastError().
extern "C" int pt_swiglu_fwd(const void* x, const void* g, void* y, int n, int f, long long sx,
                             long long sg, int x_type, int g_type, void* stream) {
  using namespace pt_fused;
  const cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || f <= 0) return (int)cudaErrorInvalidValue;
  switch (x_type) {
    case F32: return (int)swiglu_g<float>(g_type, x, g, y, n, f, sx, sg, s);
    case BF16: return (int)swiglu_g<__nv_bfloat16>(g_type, x, g, y, n, f, sx, sg, s);
    case F16: return (int)swiglu_g<__half>(g_type, x, g, y, n, f, sx, sg, s);
  }
  return (int)cudaErrorInvalidValue;
}
