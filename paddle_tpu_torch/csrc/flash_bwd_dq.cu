// Causal flash-attention backward, dQ, for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py `_dq_kernel` (launched
// from `_bwd`). Same function: for one query tile, loop over key tiles up to
// the diagonal (the forward's early exit); recompute p = exp(s - lse) under
// the forward's mask, dP = dO V^T, dS = p (dP - delta) scale and
// dQ += dS K, all in fp32, written once in the io type.
//
// What bounds it on the H100 at the training shapes (BH = 128, S = 1024,
// D = 64, bf16, causal): three products over the causal half, 2.6e10 FLOP
// (26 us at 989 TFLOP/s), against 85 MB of q, k, v, dO, lse, delta and dq
// (25 us at 3.35 TB/s): the two bounds nearly meet. This first kernel does
// its products as fp32 FMAs from shared memory, so the FMA rate and
// shared-memory reads bound it instead. What the design does: q, dO, lse and
// delta stay in shared memory for the whole block, dQ accumulates in
// registers, k and v are streamed once per query tile, and key tiles past the
// diagonal are never loaded. Splitting dQ from dK/dV (as the TPU kernel
// does) costs a second recompute of s and dP but needs no atomics.
//
// Grid: (ceil(Sq / 64), BH); one block per (bh, 64-row query tile).
#include "flash_common.cuh"

namespace pt_flash {

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int sq, int sk,
                    int causal, float scale, int kv_len, int q_offset) {
  constexpr int LD = D + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;            // [BQ][LD]
  float* dOs = Qs + BQ * LD;   // [BQ][LD]
  float* Ks = dOs + BQ * LD;   // [BK][LD]
  float* Vs = Ks + BK * LD;    // [BK][LD]
  float* dSs = Vs + BK * LD;   // [BQ][LDP]
  float* Ls = dSs + BQ * LDP;  // [BQ]
  float* Dl = Ls + BQ;         // [BQ]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const T* kb = k + (size_t)bh * sk * D;
  const T* vb = v + (size_t)bh * sk * D;

  load_tile<T, BQ, D>(Qs, q + (size_t)bh * sq * D, q0, sq);
  load_tile<T, BQ, D>(dOs, dout + (size_t)bh * sq * D, q0, sq);
  load_rowvec(Ls, lse + (size_t)bh * sq, q0, sq, BQ);
  load_rowvec(Dl, delta + (size_t)bh * sq, q0, sq, BQ);

  float dq_acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DJ; ++c) dq_acc[i][c] = 0.f;

  const int kend = key_end(q0, sq, kv_len, causal, q_offset);
  const int nkt = (kend + BK - 1) / BK;
  for (int j = 0; j < nkt; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // the last tile's reads of Ks and dSs are done
    load_tile<T, BK, D>(Ks, kb, k0, sk);
    load_tile<T, BK, D>(Vs, vb, k0, sk);
    __syncthreads();

    // s = Q K^T and dP = dO V^T; thread holds query rows ty + 16 i, keys tx + 16 b
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[i][b] = dp[i][b] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[4], oa[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = Qs[(ty + 16 * i) * LD + d];
        oa[i] = dOs[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        kv[b] = Ks[(tx + 16 * b) * LD + d];
        vv[b] = Vs[(tx + 16 * b) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          s[i][b] = fmaf(qa[i], kv[b], s[i][b]);
          dp[i][b] = fmaf(oa[i], vv[b], dp[i][b]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int col = tx + 16 * b;
        const bool ok = visible(q0 + r, k0 + col, sq, kv_len, causal, q_offset);
        const float p = ok ? expf(s[i][b] * scale - Ls[r]) : 0.f;
        dSs[r * LDP + col] = p * (dp[i][b] - Dl[r]) * scale;
      }
    }
    __syncthreads();

    // dQ += dS K; thread holds query rows ty + 16 i, dims tx + 16 c
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float sa[4], kr[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) sa[i] = dSs[(ty + 16 * i) * LDP + kk];
#pragma unroll
      for (int c = 0; c < DJ; ++c) kr[c] = Ks[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DJ; ++c) dq_acc[i][c] = fmaf(sa[i], kr[c], dq_acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= sq) continue;
    T* row = dq + ((size_t)bh * sq + qp) * D;
#pragma unroll
    for (int c = 0; c < DJ; ++c) row[tx + 16 * c] = from_f<T>(dq_acc[i][c]);
  }
}

template <typename T, int D>
cudaError_t dq_launch(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int bh, int sq, int sk,
                      int causal, float scale, int kv_len, int q_offset, void* stream) {
  const size_t smem = sizeof(float) * (4 * 64 * (D + 1) + BQ * LDP + 2 * BQ);
  const dim3 grid((sq + BQ - 1) / BQ, bh);
  return launch(flash_bwd_dq_kernel<T, D>, grid, smem, stream, (const T*)q, (const T*)k,
                (const T*)v, (const T*)dout, (const float*)lse, (const float*)delta, (T*)dq, sq,
                sk, causal, scale, kv_len, q_offset);
}

template <typename T>
cudaError_t dq_d(int d, const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* delta, void* dq, int bh, int sq, int sk, int causal,
                 float scale, int kv_len, int q_offset, void* stream) {
  switch (d) {
    case 32: return dq_launch<T, 32>(q, k, v, dout, lse, delta, dq, bh, sq, sk, causal, scale, kv_len, q_offset, stream);
    case 64: return dq_launch<T, 64>(q, k, v, dout, lse, delta, dq, bh, sq, sk, causal, scale, kv_len, q_offset, stream);
    case 128: return dq_launch<T, 128>(q, k, v, dout, lse, delta, dq, bh, sq, sk, causal, scale, kv_len, q_offset, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace pt_flash

// q, dout, dq [bh, sq, d] and k, v [bh, sk, d] in the io type; lse and delta
// float [bh, sq]. Launches on `stream` and returns cudaGetLastError().
extern "C" int pt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, void* dq, int bh, int sq,
                               int sk, int d, int is_bf16, int causal, float scale, int kv_len,
                               int q_offset, void* stream) {
  cudaError_t err = is_bf16
      ? pt_flash::dq_d<__nv_bfloat16>(d, q, k, v, dout, lse, delta, dq, bh, sq, sk, causal,
                                      scale, kv_len, q_offset, stream)
      : pt_flash::dq_d<float>(d, q, k, v, dout, lse, delta, dq, bh, sq, sk, causal, scale,
                              kv_len, q_offset, stream);
  return (int)err;
}
