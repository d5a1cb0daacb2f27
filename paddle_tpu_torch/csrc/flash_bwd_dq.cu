// Flash-attention backward, dQ, for Hopper (sm_90a): fixed-length causal
// batches, packed variable-length sequences and flashmask (start/end row)
// masks, one kernel templated on the mask.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py `_dq_kernel` (launched
// from `_bwd`; entry `pt_flash_bwd_dq`, CausalMask),
// paddle_tpu/ops/pallas/flash_varlen.py `_v_dq_kernel` (launched from
// `_varlen_bwd`; entry `pt_varlen_bwd_dq`, SegmentMask) and flash_varlen.py
// `_fm_dq_kernel` (launched from `_fm_bwd`; entry `pt_flashmask_bwd_dq`,
// StartEndMask). Same function: for
// one query tile, loop over the key tiles the forward visits; recompute
// p = exp(s - lse) under the forward's mask, dP = dO V^T,
// dS = p (dP - delta) scale and dQ += dS K, all in fp32, written once in
// the io type; a row that sees no key gets 0.
//
// What bounds it on the H100: three products over the kept pairs. At the
// fixed-length training shape (BH = 128, S = 1024, D = 64, bf16, causal)
// 2.6e10 FLOP (26 us at 989 TFLOP/s) against 85 MB of q, k, v, dO, lse,
// delta and dq (25 us at 3.35 TB/s), the two bounds nearly meet; at the
// packed shape (T = 8192, H = 16, ten causal documents) 3.6e10 FLOP
// (36 us) against 85 MB (25 us): the operations; at the flashmask shape
// (BH = 32, S = 4096, 5.3e6 kept pairs per head) 3.3e10 FLOP (33 us)
// against 85 MB (25 us): the operations. This first kernel does
// its products as fp32 FMAs from shared memory, so the FMA rate and
// shared-memory reads bound it instead. What the design does: q, dO, lse
// and delta stay in shared memory for the whole block, dQ accumulates in
// registers, k and v are streamed once per query tile, and key tiles the
// mask rules out (past the diagonal, outside the segments, or fully
// banned) are never loaded. Splitting dQ from dK/dV (as the TPU
// kernel does) costs a second recompute of s and dP but needs no atomics.
//
// Grid: (ceil(Sq / 64), heads); one block per (head, 64-row query tile).
#include "flash_common.cuh"

namespace pt_flash {

template <typename T, int D, typename Mask>
// Shared memory allows two blocks per SM at head_dim <= 64 (one at 128):
// saying so keeps ptxas from squeezing the kernel into 64 registers with
// spills to reach an occupancy the shared memory rules out.
__global__ void __launch_bounds__(NT, 2)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, Layout lay,
                    Mask heads_mask, float scale) {
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
  const int h = blockIdx.y;
  const Mask mask = heads_mask.at_head(h);
  const int qt = blockIdx.x;
  const int q0 = qt * BQ;
  const T* kb = k + h * lay.k_hs;
  const T* vb = v + h * lay.k_hs;

  load_tile<T, BQ, D>(Qs, q + h * lay.q_hs, q0, lay.sq, lay.q_rs);
  load_tile<T, BQ, D>(dOs, dout + h * lay.q_hs, q0, lay.sq, lay.q_rs);
  load_rowvec(Ls, lse + (size_t)h * lay.sq, q0, lay.sq, BQ);
  load_rowvec(Dl, delta + (size_t)h * lay.sq, q0, lay.sq, BQ);

  float dq_acc[4][DJ];
  RowInfo qi[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qi[i] = mask.q_row(q0 + ty + 16 * i);
#pragma unroll
    for (int c = 0; c < DJ; ++c) dq_acc[i][c] = 0.f;
  }

  const int2 tiles = mask.key_tiles(qt);
  for (int j = tiles.x; j < tiles.y; ++j) {
    if (!mask.tile_open(qt, j)) continue;  // the same for the whole block
    const int k0 = j * BK;
    RowInfo ki[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) ki[b] = mask.k_row(k0 + tx + 16 * b);
    __syncthreads();  // the last tile's reads of Ks and dSs are done
    load_tile<T, BK, D>(Ks, kb, k0, lay.sk, lay.k_rs);
    load_tile<T, BK, D>(Vs, vb, k0, lay.sk, lay.k_rs);
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
        const bool ok = mask.visible(qi[i], ki[b]);
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
    if (qp >= lay.sq) continue;
    T* row = dq + h * lay.q_hs + qp * lay.q_rs;
#pragma unroll
    for (int c = 0; c < DJ; ++c) row[tx + 16 * c] = from_f<T>(dq_acc[i][c]);
  }
}

template <typename T, int D, typename Mask>
cudaError_t dq_launch(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int heads, Layout lay,
                      Mask mask, float scale, void* stream) {
  const size_t smem = sizeof(float) * (4 * 64 * (D + 1) + BQ * LDP + 2 * BQ);
  const dim3 grid((lay.sq + BQ - 1) / BQ, heads);
  return launch(flash_bwd_dq_kernel<T, D, Mask>, grid, smem, stream, (const T*)q, (const T*)k,
                (const T*)v, (const T*)dout, (const float*)lse, (const float*)delta, (T*)dq, lay,
                mask, scale);
}

template <typename Mask>
cudaError_t dq_any(int d, int is_bf16, const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta, void* dq, int heads,
                   Layout lay, Mask mask, float scale, void* stream) {
  if (is_bf16) {
    PT_FLASH_SWITCH_D(d, return dq_launch<__nv_bfloat16, D>(q, k, v, dout, lse, delta, dq, heads,
                                                             lay, mask, scale, stream))
  }
  PT_FLASH_SWITCH_D(d, return dq_launch<float, D>(q, k, v, dout, lse, delta, dq, heads, lay, mask,
                                                  scale, stream))
}

}  // namespace pt_flash

// q, dout, dq [bh, sq, d] and k, v [bh, sk, d] in the io type, contiguous;
// lse and delta float [bh, sq]. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int pt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, void* dq, int bh, int sq,
                               int sk, int d, int is_bf16, int causal, float scale, int kv_len,
                               int q_offset, void* stream) {
  const pt_flash::CausalMask mask{sq, causal, kv_len, q_offset};
  return (int)pt_flash::dq_any(d, is_bf16, q, k, v, dout, lse, delta, dq, bh,
                               pt_flash::dense_layout(sq, sk, d), mask, scale, stream);
}

// q, dout, dq [tq, h, d] and k, v [tk, h, d] in the io type, contiguous; lse
// and delta float [h, tq]; seg/pos and lo/hi as for pt_varlen_fwd. Launches
// on `stream` and returns cudaGetLastError().
extern "C" int pt_varlen_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dq, const int* seg_q,
                                const int* pos_q, const int* seg_k, const int* pos_k,
                                const int* lo, const int* hi, int h, int tq, int tk, int d,
                                int is_bf16, int causal, float scale, void* stream) {
  const pt_flash::SegmentMask mask{seg_q, pos_q, seg_k, pos_k, lo, hi, causal};
  return (int)pt_flash::dq_any(d, is_bf16, q, k, v, dout, lse, delta, dq, h,
                               pt_flash::packed_layout(tq, tk, h, d), mask, scale, stream);
}

// q, dout, dq [bh, sq, d] and k, v [bh, sk, d] in the io type, contiguous;
// lse and delta float [bh, sq]; st/en/st_max/en_min as for
// pt_flashmask_fwd. Launches on `stream` and returns cudaGetLastError().
extern "C" int pt_flashmask_bwd_dq(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   void* dq, const int* st, const int* en, const int* st_max,
                                   const int* en_min, int bh, int h, int hs, int sq, int sk,
                                   int d, int is_bf16, int causal, float scale, void* stream) {
  const pt_flash::StartEndMask mask{st, en, st_max, en_min, h, hs, sq, sk, causal};
  return (int)pt_flash::dq_any(d, is_bf16, q, k, v, dout, lse, delta, dq, bh,
                               pt_flash::dense_layout(sq, sk, d), mask, scale, stream);
}
