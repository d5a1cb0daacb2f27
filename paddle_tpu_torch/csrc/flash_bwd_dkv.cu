// Causal flash-attention backward, dK and dV, for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py `_dkv_kernel` (launched
// from `_bwd`). Same function: for one key tile, loop over the query tiles
// from the first one that reaches the diagonal; recompute p = exp(s - lse)
// under the forward's mask, then dV += p^T dO, dP = dO V^T,
// dS = p (dP - delta) scale, dK += dS^T Q, all in fp32; delta = rowsum(dO o)
// comes in precomputed. dK and dV are written once, in the io type.
//
// What bounds it on the H100 at the training shapes (BH = 128, S = 1024,
// D = 64, bf16, causal): four products over the causal half, 3.4e10 FLOP
// (35 us at 989 TFLOP/s), against 102 MB of q, k, v, dO, lse, delta, dk and
// dv (30 us at 3.35 TB/s): the operations bound it, barely. This first
// kernel does its products as fp32 FMAs from shared memory, so the FMA rate
// and shared-memory reads bound it instead. What the design does: k and v
// stay in shared memory for the whole block, dK and dV accumulate in
// registers (a 4 x D/16 block each per thread) and never round-trip to
// device memory, and query tiles above the diagonal are never loaded.
//
// Grid: (ceil(Sk / 64), BH); one block per (bh, 64-row key tile).
#include "flash_common.cuh"

namespace pt_flash {

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int sq, int sk, int causal, float scale, int kv_len, int q_offset) {
  constexpr int LD = D + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;            // [BK][LD]
  float* Vs = Ks + BK * LD;    // [BK][LD]
  float* Qs = Vs + BK * LD;    // [BQ][LD]
  float* dOs = Qs + BQ * LD;   // [BQ][LD]
  float* Ps = dOs + BQ * LD;   // [BQ][LDP]
  float* dSs = Ps + BQ * LDP;  // [BQ][LDP]
  float* Ls = dSs + BQ * LDP;  // [BQ]
  float* Dl = Ls + BQ;         // [BQ]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const T* qb = q + (size_t)bh * sq * D;
  const T* dob = dout + (size_t)bh * sq * D;
  const float* lb = lse + (size_t)bh * sq;
  const float* db = delta + (size_t)bh * sq;

  load_tile<T, BK, D>(Ks, k + (size_t)bh * sk * D, k0, sk);
  load_tile<T, BK, D>(Vs, v + (size_t)bh * sk * D, k0, sk);

  float dk_acc[4][DJ], dv_acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DJ; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // query rows before this key tile's first diagonal see none of it; a tile
  // wholly past kv_len is seen by no query
  int qt_begin = 0;
  if (causal && k0 - q_offset > 0) qt_begin = (k0 - q_offset) / BQ;
  const int nqt = k0 < kv_len ? (sq + BQ - 1) / BQ : 0;

  for (int it = qt_begin; it < nqt; ++it) {
    const int q0 = it * BQ;
    __syncthreads();  // the last tile's reads of Qs, dOs, Ps, dSs are done
    load_tile<T, BQ, D>(Qs, qb, q0, sq);
    load_tile<T, BQ, D>(dOs, dob, q0, sq);
    load_rowvec(Ls, lb, q0, sq, BQ);
    load_rowvec(Dl, db, q0, sq, BQ);
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
        Ps[r * LDP + col] = p;
        dSs[r * LDP + col] = p * (dp[i][b] - Dl[r]) * scale;
      }
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q; thread holds key rows ty + 16 i, dims tx + 16 c
#pragma unroll 4
    for (int qq = 0; qq < BQ; ++qq) {
      float pa[4], sa[4], ob[DJ], qv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] = Ps[qq * LDP + ty + 16 * i];
        sa[i] = dSs[qq * LDP + ty + 16 * i];
      }
#pragma unroll
      for (int c = 0; c < DJ; ++c) {
        ob[c] = dOs[qq * LD + tx + 16 * c];
        qv[c] = Qs[qq * LD + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DJ; ++c) {
          dv_acc[i][c] = fmaf(pa[i], ob[c], dv_acc[i][c]);
          dk_acc[i][c] = fmaf(sa[i], qv[c], dk_acc[i][c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + ty + 16 * i;
    if (kp >= sk) continue;
    T* dkrow = dk + ((size_t)bh * sk + kp) * D;
    T* dvrow = dv + ((size_t)bh * sk + kp) * D;
#pragma unroll
    for (int c = 0; c < DJ; ++c) {
      dkrow[tx + 16 * c] = from_f<T>(dk_acc[i][c]);
      dvrow[tx + 16 * c] = from_f<T>(dv_acc[i][c]);
    }
  }
}

template <typename T, int D>
cudaError_t dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                const void* delta, void* dk, void* dv, int bh, int sq, int sk, int causal,
                float scale, int kv_len, int q_offset, void* stream) {
  const size_t smem = sizeof(float) * (4 * 64 * (D + 1) + 2 * BQ * LDP + 2 * BQ);
  const dim3 grid((sk + BK - 1) / BK, bh);
  return launch(flash_bwd_dkv_kernel<T, D>, grid, smem, stream, (const T*)q, (const T*)k,
                (const T*)v, (const T*)dout, (const float*)lse, (const float*)delta, (T*)dk,
                (T*)dv, sq, sk, causal, scale, kv_len, q_offset);
}

template <typename T>
cudaError_t dkv_d(int d, const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, void* dk, void* dv, int bh, int sq, int sk,
                  int causal, float scale, int kv_len, int q_offset, void* stream) {
  switch (d) {
    case 32: return dkv<T, 32>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, causal, scale, kv_len, q_offset, stream);
    case 64: return dkv<T, 64>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, causal, scale, kv_len, q_offset, stream);
    case 128: return dkv<T, 128>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, causal, scale, kv_len, q_offset, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace pt_flash

// q, dout [bh, sq, d] and k, v, dk, dv [bh, sk, d] in the io type; lse and
// delta float [bh, sq]. Launches on `stream` and returns cudaGetLastError().
extern "C" int pt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dk, void* dv, int bh,
                                int sq, int sk, int d, int is_bf16, int causal, float scale,
                                int kv_len, int q_offset, void* stream) {
  cudaError_t err = is_bf16
      ? pt_flash::dkv_d<__nv_bfloat16>(d, q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, causal,
                                       scale, kv_len, q_offset, stream)
      : pt_flash::dkv_d<float>(d, q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, causal, scale,
                               kv_len, q_offset, stream);
  return (int)err;
}
