// Causal flash-attention forward for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py `_fwd_kernel` (reached
// through `_fwd_call`). Same function: online-softmax attention, fp32 logits,
// running max m, running sum l and fp32 accumulator, bottom-right causal mask
// k <= q + (Sk - Sq), keys masked by kv_len, key tiles past the diagonal
// skipped, P rounded to the io type before P.V, lse = m + log(l) in fp32 and
// a row with l == 0 written as 0.
//
// What bounds it on the H100 at the training shapes (BH = 128, S = 1024,
// D = 64, bf16, causal): 1.7e10 FLOP (17 us at 989 TFLOP/s) against 67 MB
// of q, k, v, o and lse (20 us at 3.35 TB/s), so device memory bounds the
// function. This first kernel does its products as fp32 FMAs from shared
// memory, not on the tensor cores, so it is bound by the FMA rate and by
// shared-memory reads instead: each thread holds a 4 x 4 block of scores and
// a 4 x D/16 block of the output in registers and reads 8 shared words per
// 16 FMAs. What the design does about the memory bound: every q tile is read
// once, k and v are streamed tile by tile and reused by the 64 query rows of
// the block, and no score ever reaches device memory.
//
// Grid: (ceil(Sq / 64), BH); one block per (bh, 64-row query tile).
#include "flash_common.cuh"

namespace pt_flash {

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int sq, int sk, int causal,
                 float scale, int kv_len, int q_offset) {
  constexpr int LD = D + 1;
  constexpr int DJ = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;          // [BQ][LD]
  float* Ks = Qs + BQ * LD;  // [BK][LD]
  float* Vs = Ks + BK * LD;  // [BK][LD]
  float* Ps = Vs + BK * LD;  // [BQ][LDP]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const T* qb = q + (size_t)bh * sq * D;
  const T* kb = k + (size_t)bh * sk * D;
  const T* vb = v + (size_t)bh * sk * D;

  load_tile<T, BQ, D>(Qs, qb, q0, sq);

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DJ; ++c) acc[i][c] = 0.f;
  }

  const int kend = key_end(q0, sq, kv_len, causal, q_offset);
  const int nkt = (kend + BK - 1) / BK;
  for (int j = 0; j < nkt; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // the last tile's reads of Ks, Vs and Ps are done
    load_tile<T, BK, D>(Ks, kb, k0, sk);
    load_tile<T, BK, D>(Vs, vb, k0, sk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[i][b] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int b = 0; b < 4; ++b) kv[b] = Ks[(tx + 16 * b) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int b = 0; b < 4; ++b) s[i][b] = fmaf(qa[i], kv[b], s[i][b]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        ok[b] = visible(qp, k0 + tx + 16 * b, sq, kv_len, causal, q_offset);
        s[i][b] = ok[b] ? s[i][b] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][b]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float p = ok[b] ? expf(s[i][b] - m_new) : 0.f;
        rs += p;
        Ps[(ty + 16 * i) * LDP + tx + 16 * b] = round_io<T>(p);
      }
      l[i] = alpha * l[i] + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DJ; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pa[4], vb2[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = Ps[(ty + 16 * i) * LDP + kk];
#pragma unroll
      for (int c = 0; c < DJ; ++c) vb2[c] = Vs[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DJ; ++c) acc[i][c] = fmaf(pa[i], vb2[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= sq) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    T* orow = o + ((size_t)bh * sq + qp) * D;
#pragma unroll
    for (int c = 0; c < DJ; ++c) orow[tx + 16 * c] = from_f<T>(acc[i][c] / l_safe);
    if (tx == 0) lse[(size_t)bh * sq + qp] = m[i] + logf(l_safe);
  }
}

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int sq,
                int sk, int causal, float scale, int kv_len, int q_offset, void* stream) {
  const size_t smem = sizeof(float) * (3 * 64 * (D + 1) + BQ * LDP);
  const dim3 grid((sq + BQ - 1) / BQ, bh);
  return launch(flash_fwd_kernel<T, D>, grid, smem, stream, (const T*)q, (const T*)k,
                (const T*)v, (T*)o, (float*)lse, sq, sk, causal, scale, kv_len, q_offset);
}

template <typename T>
cudaError_t fwd_d(int d, const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                  int sq, int sk, int causal, float scale, int kv_len, int q_offset,
                  void* stream) {
  switch (d) {
    case 32: return fwd<T, 32>(q, k, v, o, lse, bh, sq, sk, causal, scale, kv_len, q_offset, stream);
    case 64: return fwd<T, 64>(q, k, v, o, lse, bh, sq, sk, causal, scale, kv_len, q_offset, stream);
    case 128: return fwd<T, 128>(q, k, v, o, lse, bh, sq, sk, causal, scale, kv_len, q_offset, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace pt_flash

// q, k, v, o in the io type (is_bf16 ? bf16 : float); lse float [bh, sq].
// Launches on `stream` and returns cudaGetLastError().
extern "C" int pt_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                            int bh, int sq, int sk, int d, int is_bf16, int causal, float scale,
                            int kv_len, int q_offset, void* stream) {
  cudaError_t err = is_bf16
      ? pt_flash::fwd_d<__nv_bfloat16>(d, q, k, v, o, lse, bh, sq, sk, causal, scale, kv_len,
                                       q_offset, stream)
      : pt_flash::fwd_d<float>(d, q, k, v, o, lse, bh, sq, sk, causal, scale, kv_len, q_offset,
                               stream);
  return (int)err;
}
