// Shared pieces of the causal flash-attention kernels (forward, dK/dV, dQ).
//
// Layout: q, o, dO are [BH, Sq, D]; k, v are [BH, Sk, D]; all contiguous, in
// the io type (float or bf16). lse and delta are [BH, Sq] float. Every block
// runs NT = 256 threads as a 16 x 16 grid (tx = tid % 16, ty = tid / 16); a
// thread owns rows {ty + 16 i} and columns {tx + 16 j} of each 64-row tile,
// so the 16 threads that share a row sit in one half-warp and reduce a row
// with four xor shuffles.
//
// Tiles live in shared memory as float with one word of padding per row
// (stride D + 1), so a column read by 16 neighbouring threads hits 16
// different banks. Products are fp32 FMAs from shared memory: the same
// numbers the TPU kernel gets from fp32-accumulating MXU products of
// io-typed inputs, since a product of two bf16 values is exact in fp32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace pt_flash {

constexpr int BQ = 64;            // query rows per tile
constexpr int BK = 64;            // key rows per tile
constexpr int NT = 256;           // threads per block
constexpr int LDP = BK + 1;       // stride of a [64 x 64] score tile in smem
constexpr float NEG_INF = -1e30f; // the TPU kernel's mask fill

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to the io type and widened again (P before P.V, as the TPU
// kernel casts p to v's dtype before its second product).
template <typename T> __device__ __forceinline__ float round_io(float x) {
  return to_f(from_f<T>(x));
}

// Rows [row0, row0 + ROWS) of a [rows, D] io-typed matrix into a float smem
// tile of stride D + 1; rows past the end read as 0.
template <typename T, int ROWS, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int row0, int rows) {
  constexpr int LD = D + 1;
  for (int idx = threadIdx.x; idx < ROWS * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const int gr = row0 + r;
    dst[r * LD + c] = gr < rows ? to_f(src[(size_t)gr * D + c]) : 0.f;
  }
}

// Entries [row0, row0 + n) of a float row vector (lse, delta); past the end 0.
__device__ __forceinline__ void load_rowvec(float* dst, const float* __restrict__ src,
                                            int row0, int rows, int n) {
  for (int idx = threadIdx.x; idx < n; idx += NT) {
    const int gr = row0 + idx;
    dst[idx] = gr < rows ? src[gr] : 0.f;
  }
}

// Max and sum over the 16 lanes of a half-warp (one row of a tile).
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Key kp is seen by query qp: inside kv_len and, when causal, on or below the
// bottom-right-aligned diagonal kp <= qp + q_offset (q_offset = Sk - Sq).
__device__ __forceinline__ bool visible(int qp, int kp, int sq, int kv_len, int causal,
                                        int q_offset) {
  return qp < sq && kp < kv_len && (!causal || kp <= qp + q_offset);
}

// One past the last key that any query row of the tile starting at q0 sees.
__device__ __forceinline__ int key_end(int q0, int sq, int kv_len, int causal, int q_offset) {
  int end = kv_len;
  if (causal) {
    const int last_q = min(q0 + BQ, sq) - 1;
    end = min(end, last_q + q_offset + 1);
  }
  return max(end, 0);
}

// Sets the block's dynamic shared memory limit, then launches.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, void* stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace pt_flash
