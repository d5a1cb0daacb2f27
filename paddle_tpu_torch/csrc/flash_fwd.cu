// Flash-attention forward for Hopper (sm_90a): fixed-length causal batches,
// packed variable-length sequences and flashmask (start/end row) masks, one
// kernel templated on the mask.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py `_fwd_kernel` (reached
// through `_fwd_call`; entry `pt_flash_fwd`, CausalMask),
// paddle_tpu/ops/pallas/flash_varlen.py `_v_fwd_kernel` (reached through
// `_varlen_fwd`; entry `pt_varlen_fwd`, SegmentMask) and flash_varlen.py
// `_fm_fwd_kernel` (reached through `_fm_fwd`; entry `pt_flashmask_fwd`,
// StartEndMask). Same function: online-softmax attention, fp32 logits,
// running max m, running sum l and fp32 accumulator, the mask applied
// before the max and again after exp, only the key tiles the mask can reach
// visited (and, for flashmask, fully banned tiles skipped), P rounded to the
// io type before P.V, lse = m + log(l) in fp32, and a row with l == 0
// written as 0 with the mask's empty-row lse (-1e30 fixed-length, 0 varlen
// and flashmask).
//
// What bounds it on the H100: at the fixed-length training shape (BH = 128,
// S = 1024, D = 64, bf16, causal) 1.7e10 FLOP (17 us at 989 TFLOP/s)
// against 67 MB of q, k, v, o and lse (20 us at 3.35 TB/s): device memory.
// At the packed shape (T = 8192, H = 16, D = 64, bf16, ten causal
// documents, 5.8e6 kept pairs per head) 2.4e10 FLOP (24 us) against 68 MB
// (20 us): the operations, barely. At the flashmask shape (BH = 32,
// S = 4096, D = 64, bf16, causal, one batch row of share-question and one
// of document masks, 5.3e6 kept pairs per head) 2.2e10 FLOP (22 us) against
// 68 MB (20 us): the operations. This first kernel does its products as
// fp32 FMAs from shared memory, not on the tensor cores, so it is bound by
// the FMA rate and by shared-memory reads instead: each thread holds a
// 4 x 4 block of scores and a 4 x D/16 block of the output in registers
// and reads 8 shared words per 16 FMAs. What the design does about the
// memory bound: every q tile is read once, k and v are streamed tile by
// tile and reused by the 64 query rows of the block, no score ever reaches
// device memory, packed rows are read in place through their strides
// (no [H, T, D] copy), and a flashmask start/end row shared by the heads is
// read in place by each of them (no [B, H, S] copy).
//
// Grid: (ceil(Sq / 64), heads); one block per (head, 64-row query tile).
#include "flash_common.cuh"

namespace pt_flash {

template <typename T, int D, typename Mask>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, Layout lay, Mask heads_mask,
                 float scale) {
  constexpr int LD = D + 1;
  constexpr int DJ = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;          // [BQ][LD]
  float* Ks = Qs + BQ * LD;  // [BK][LD]
  float* Vs = Ks + BK * LD;  // [BK][LD]
  float* Ps = Vs + BK * LD;  // [BQ][LDP]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int h = blockIdx.y;
  const Mask mask = heads_mask.at_head(h);
  const int qt = blockIdx.x;
  const int q0 = qt * BQ;
  const T* kb = k + h * lay.k_hs;
  const T* vb = v + h * lay.k_hs;

  load_tile<T, BQ, D>(Qs, q + h * lay.q_hs, q0, lay.sq, lay.q_rs);

  float m[4], l[4], acc[4][DJ];
  RowInfo qi[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
    qi[i] = mask.q_row(q0 + ty + 16 * i);
#pragma unroll
    for (int c = 0; c < DJ; ++c) acc[i][c] = 0.f;
  }

  const int2 tiles = mask.key_tiles(qt);
  for (int j = tiles.x; j < tiles.y; ++j) {
    if (!mask.tile_open(qt, j)) continue;  // the same for the whole block
    const int k0 = j * BK;
    __syncthreads();  // the last tile's reads of Ks, Vs and Ps are done
    load_tile<T, BK, D>(Ks, kb, k0, lay.sk, lay.k_rs);
    load_tile<T, BK, D>(Vs, vb, k0, lay.sk, lay.k_rs);
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

    RowInfo ki[4];  // fetched here, not kept live through the products
#pragma unroll
    for (int b = 0; b < 4; ++b) ki[b] = mask.k_row(k0 + tx + 16 * b);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        ok[b] = mask.visible(qi[i], ki[b]);
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
    if (qp >= lay.sq) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    T* orow = o + h * lay.q_hs + qp * lay.q_rs;
#pragma unroll
    for (int c = 0; c < DJ; ++c) orow[tx + 16 * c] = from_f<T>(acc[i][c] / l_safe);
    if (tx == 0)
      lse[(size_t)h * lay.sq + qp] = l[i] == 0.f ? Mask::empty_lse() : m[i] + logf(l[i]);
  }
}

template <typename T, int D, typename Mask>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o, void* lse, int heads,
                Layout lay, Mask mask, float scale, void* stream) {
  const size_t smem = sizeof(float) * (3 * 64 * (D + 1) + BQ * LDP);
  const dim3 grid((lay.sq + BQ - 1) / BQ, heads);
  return launch(flash_fwd_kernel<T, D, Mask>, grid, smem, stream, (const T*)q, (const T*)k,
                (const T*)v, (T*)o, (float*)lse, lay, mask, scale);
}

template <typename Mask>
cudaError_t fwd_any(int d, int is_bf16, const void* q, const void* k, const void* v, void* o,
                    void* lse, int heads, Layout lay, Mask mask, float scale, void* stream) {
  if (is_bf16) {
    PT_FLASH_SWITCH_D(d, return fwd<__nv_bfloat16, D>(q, k, v, o, lse, heads, lay, mask, scale,
                                                       stream))
  }
  PT_FLASH_SWITCH_D(d, return fwd<float, D>(q, k, v, o, lse, heads, lay, mask, scale, stream))
}

}  // namespace pt_flash

// q, k, v, o [bh, s, d] in the io type (is_bf16 ? bf16 : float), contiguous;
// lse float [bh, sq]. Launches on `stream` and returns cudaGetLastError().
extern "C" int pt_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                            int bh, int sq, int sk, int d, int is_bf16, int causal, float scale,
                            int kv_len, int q_offset, void* stream) {
  const pt_flash::CausalMask mask{sq, causal, kv_len, q_offset};
  return (int)pt_flash::fwd_any(d, is_bf16, q, k, v, o, lse, bh,
                                pt_flash::dense_layout(sq, sk, d), mask, scale, stream);
}

// q, o [tq, h, d] and k, v [tk, h, d] in the io type, contiguous; lse float
// [h, tq]. seg_q/pos_q int32 [ceil(tq / 64) * 64], seg_k/pos_k int32
// [ceil(tk / 64) * 64]; lo/hi int32 [ceil(tq / 64)]: the key tiles each
// query tile visits. Launches on `stream` and returns cudaGetLastError().
extern "C" int pt_varlen_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                             const int* seg_q, const int* pos_q, const int* seg_k,
                             const int* pos_k, const int* lo, const int* hi, int h, int tq,
                             int tk, int d, int is_bf16, int causal, float scale, void* stream) {
  const pt_flash::SegmentMask mask{seg_q, pos_q, seg_k, pos_k, lo, hi, causal};
  return (int)pt_flash::fwd_any(d, is_bf16, q, k, v, o, lse, h,
                                pt_flash::packed_layout(tq, tk, h, d), mask, scale, stream);
}

// q, k, v, o [bh, sq or sk, d] in the io type, contiguous; lse float
// [bh, sq]. st/en int32 [bh / h * hs, sk]: key kp bans query rows
// [st, en) (hs = 1: one row per batch row, shared by its h heads; hs = h:
// one per head); st_max/en_min int32 [bh / h * hs, ceil(sk / 64)]: their
// max and min over each 64-column tile. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int pt_flashmask_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                                const int* st, const int* en, const int* st_max,
                                const int* en_min, int bh, int h, int hs, int sq, int sk, int d,
                                int is_bf16, int causal, float scale, void* stream) {
  const pt_flash::StartEndMask mask{st, en, st_max, en_min, h, hs, sq, sk, causal};
  return (int)pt_flash::fwd_any(d, is_bf16, q, k, v, o, lse, bh,
                                pt_flash::dense_layout(sq, sk, d), mask, scale, stream);
}
