// Flash-attention backward, dK and dV, for Hopper (sm_90a): fixed-length
// causal batches, packed variable-length sequences and flashmask (start/end
// row) masks, one kernel templated on the mask.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py `_dkv_kernel`
// (launched from `_bwd`; entry `pt_flash_bwd_dkv`, CausalMask),
// paddle_tpu/ops/pallas/flash_varlen.py `_v_dkv_kernel` (launched from
// `_varlen_bwd`; entry `pt_varlen_bwd_dkv`, SegmentMask) and flash_varlen.py
// `_fm_dkv_kernel` (launched from `_fm_bwd`; entry `pt_flashmask_bwd_dkv`,
// StartEndMask). Same function: for
// one key tile, loop over the query tiles the mask lets see it; recompute
// p = exp(s - lse) under the forward's mask, then dV += p^T dO,
// dP = dO V^T, dS = p (dP - delta) scale, dK += dS^T Q, all in fp32;
// delta = rowsum(dO o) comes in precomputed. dK and dV are written once, in
// the io type; a key no query sees gets 0.
//
// What bounds it on the H100: four products over the kept pairs. At the
// fixed-length training shape (BH = 128, S = 1024, D = 64, bf16, causal)
// 3.4e10 FLOP (35 us at 989 TFLOP/s) against 102 MB of q, k, v, dO, lse,
// delta, dk and dv (30 us at 3.35 TB/s); at the packed shape (T = 8192,
// H = 16, ten causal documents) 4.8e10 FLOP (48 us) against 102 MB
// (30 us): the operations in both; at the flashmask shape (BH = 32,
// S = 4096, 5.3e6 kept pairs per head) 4.4e10 FLOP (44 us) against 102 MB
// (30 us): the operations. This first kernel does its products as
// fp32 FMAs from shared memory, so the FMA rate and shared-memory reads
// bound it instead. What the design does: k and v stay in shared memory for
// the whole block, dK and dV accumulate in registers (a 4 x D/16 block each
// per thread) and never round-trip to device memory, and query tiles the
// mask rules out (above the diagonal, outside the key tile's segments, or
// banned by every column of the key tile) are never loaded.
//
// Grid: (ceil(Sk / 64), heads); one block per (head, 64-row key tile).
#include "flash_common.cuh"

namespace pt_flash {

template <typename T, int D, typename Mask>
// Shared memory allows two blocks per SM at head_dim <= 64 (one at 128):
// saying so keeps ptxas from squeezing the kernel into 64 registers with
// spills to reach an occupancy the shared memory rules out.
__global__ void __launch_bounds__(NT, 2)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     Layout lay, Mask heads_mask, float scale) {
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
  const int h = blockIdx.y;
  const Mask mask = heads_mask.at_head(h);
  const int kt = blockIdx.x;
  const int k0 = kt * BK;
  const T* qb = q + h * lay.q_hs;
  const T* dob = dout + h * lay.q_hs;
  const float* lb = lse + (size_t)h * lay.sq;
  const float* db = delta + (size_t)h * lay.sq;

  load_tile<T, BK, D>(Ks, k + h * lay.k_hs, k0, lay.sk, lay.k_rs);
  load_tile<T, BK, D>(Vs, v + h * lay.k_hs, k0, lay.sk, lay.k_rs);

  float dk_acc[4][DJ], dv_acc[4][DJ];
  RowInfo ki[4];  // the keys tx + 16 b of every score tile
#pragma unroll
  for (int b = 0; b < 4; ++b) ki[b] = mask.k_row(k0 + tx + 16 * b);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DJ; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int2 tiles = mask.query_tiles(kt);
  for (int it = tiles.x; it < tiles.y; ++it) {
    if (!mask.tile_open(it, kt)) continue;  // the same for the whole block
    const int q0 = it * BQ;
    RowInfo qi[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qi[i] = mask.q_row(q0 + ty + 16 * i);
    __syncthreads();  // the last tile's reads of Qs, dOs, Ps, dSs are done
    load_tile<T, BQ, D>(Qs, qb, q0, lay.sq, lay.q_rs);
    load_tile<T, BQ, D>(dOs, dob, q0, lay.sq, lay.q_rs);
    load_rowvec(Ls, lb, q0, lay.sq, BQ);
    load_rowvec(Dl, db, q0, lay.sq, BQ);
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
    if (kp >= lay.sk) continue;
    T* dkrow = dk + h * lay.k_hs + kp * lay.k_rs;
    T* dvrow = dv + h * lay.k_hs + kp * lay.k_rs;
#pragma unroll
    for (int c = 0; c < DJ; ++c) {
      dkrow[tx + 16 * c] = from_f<T>(dk_acc[i][c]);
      dvrow[tx + 16 * c] = from_f<T>(dv_acc[i][c]);
    }
  }
}

template <typename T, int D, typename Mask>
cudaError_t dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                const void* delta, void* dk, void* dv, int heads, Layout lay, Mask mask,
                float scale, void* stream) {
  const size_t smem = sizeof(float) * (4 * 64 * (D + 1) + 2 * BQ * LDP + 2 * BQ);
  const dim3 grid((lay.sk + BK - 1) / BK, heads);
  return launch(flash_bwd_dkv_kernel<T, D, Mask>, grid, smem, stream, (const T*)q, (const T*)k,
                (const T*)v, (const T*)dout, (const float*)lse, (const float*)delta, (T*)dk,
                (T*)dv, lay, mask, scale);
}

template <typename Mask>
cudaError_t dkv_any(int d, int is_bf16, const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta, void* dk, void* dv,
                    int heads, Layout lay, Mask mask, float scale, void* stream) {
  if (is_bf16) {
    PT_FLASH_SWITCH_D(d, return dkv<__nv_bfloat16, D>(q, k, v, dout, lse, delta, dk, dv, heads,
                                                       lay, mask, scale, stream))
  }
  PT_FLASH_SWITCH_D(d, return dkv<float, D>(q, k, v, dout, lse, delta, dk, dv, heads, lay, mask,
                                            scale, stream))
}

}  // namespace pt_flash

// q, dout [bh, sq, d] and k, v, dk, dv [bh, sk, d] in the io type,
// contiguous; lse and delta float [bh, sq]. Launches on `stream` and
// returns cudaGetLastError().
extern "C" int pt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dk, void* dv, int bh,
                                int sq, int sk, int d, int is_bf16, int causal, float scale,
                                int kv_len, int q_offset, void* stream) {
  const pt_flash::CausalMask mask{sq, causal, kv_len, q_offset};
  return (int)pt_flash::dkv_any(d, is_bf16, q, k, v, dout, lse, delta, dk, dv, bh,
                                pt_flash::dense_layout(sq, sk, d), mask, scale, stream);
}

// q, dout [tq, h, d] and k, v, dk, dv [tk, h, d] in the io type, contiguous;
// lse and delta float [h, tq]; seg/pos as for pt_varlen_fwd; lo/hi int32
// [ceil(tk / 64)]: the query tiles each key tile visits. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int pt_varlen_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dk, void* dv,
                                 const int* seg_q, const int* pos_q, const int* seg_k,
                                 const int* pos_k, const int* lo, const int* hi, int h, int tq,
                                 int tk, int d, int is_bf16, int causal, float scale,
                                 void* stream) {
  const pt_flash::SegmentMask mask{seg_q, pos_q, seg_k, pos_k, lo, hi, causal};
  return (int)pt_flash::dkv_any(d, is_bf16, q, k, v, dout, lse, delta, dk, dv, h,
                                pt_flash::packed_layout(tq, tk, h, d), mask, scale, stream);
}

// q, dout [bh, sq, d] and k, v, dk, dv [bh, sk, d] in the io type,
// contiguous; lse and delta float [bh, sq]; st/en/st_max/en_min as for
// pt_flashmask_fwd. Launches on `stream` and returns cudaGetLastError().
extern "C" int pt_flashmask_bwd_dkv(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dk, void* dv, const int* st, const int* en,
                                    const int* st_max, const int* en_min, int bh, int h, int hs,
                                    int sq, int sk, int d, int is_bf16, int causal, float scale,
                                    void* stream) {
  const pt_flash::StartEndMask mask{st, en, st_max, en_min, h, hs, sq, sk, causal};
  return (int)pt_flash::dkv_any(d, is_bf16, q, k, v, dout, lse, delta, dk, dv, bh,
                                pt_flash::dense_layout(sq, sk, d), mask, scale, stream);
}
