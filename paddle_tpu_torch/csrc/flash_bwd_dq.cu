// Flash-attention backward, dQ, for Hopper (sm_90a): fixed-length causal
// batches, packed variable-length sequences and flashmask (start/end row)
// masks, two kernels templated on the mask: a tensor-core kernel for bf16
// io (`flash_bwd_dq_hopper`) and an fp32 FMA kernel for float and fp16 io
// (`flash_bwd_dq_kernel`). `dq_any` picks one by the io type.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py `_dq_kernel` (launched
// from `_bwd`; entry `pt_flash_bwd_dq`, CausalMask),
// paddle_tpu/ops/pallas/flash_varlen.py `_v_dq_kernel` (launched from
// `_varlen_bwd`; entry `pt_varlen_bwd_dq`, SegmentMask) and flash_varlen.py
// `_fm_dq_kernel` (launched from `_fm_bwd`; entry `pt_flashmask_bwd_dq`,
// StartEndMask). Same function: for
// one query tile, loop over the key tiles the forward visits; recompute
// p = exp(s - lse) under the forward's mask, dP = dO V^T,
// dS = p (dP - delta) scale and dQ += dS K, all with fp32 p and dS,
// written once in the io type; a row that sees no key gets 0.
//
// What bounds it on the H100: three products over the kept pairs. At the
// fixed-length training shape (BH = 128, S = 1024, D = 64, bf16, causal)
// 2.6e10 FLOP (26 us at 989 TFLOP/s) against 85 MB of q, k, v, dO, lse,
// delta and dq (25 us at 3.35 TB/s), the two bounds nearly meet; at the
// packed shape (T = 8192, H = 16, ten causal documents) 3.6e10 FLOP
// (36 us) against 85 MB (25 us): the operations; at the flashmask shape
// (BH = 32, S = 4096, 5.3e6 kept pairs per head) 3.3e10 FLOP (33 us)
// against 85 MB (25 us): the operations. q, dO, lse and delta stay on
// chip for the whole block, dQ accumulates in registers, k and v are
// streamed once per query tile, and key tiles the mask rules out (past
// the diagonal, outside the segments, or fully banned) are never loaded.
// Splitting dQ from dK/dV (as the TPU kernel does) costs a second
// recompute of s and dP but needs no atomics.
//
// The bf16 kernel (`flash_bwd_dq_hopper`), one block per (head, 64-row
// query tile), one warpgroup (128 threads), four blocks an SM below
// D = 128 (at most 128 registers a thread), two at 128.
// - Thread 0 loads the Q and dO tiles by TMA and streams K and V tiles
//   through a ring of STAGES shared-memory stages, each signalled on a
//   "full" mbarrier by the TMA's byte count: the first STAGES tiles at the
//   start, then each tile into the stage the block has just finished (a
//   block barrier says when). Loads and products walk the same tiles,
//   `key_tiles(qt)` then `tile_open`. Two stages, so that four blocks fit
//   an SM's shared memory: more blocks hide more of each block's waits
//   than a deeper ring (3 stages at three blocks an SM was 3-13% slower).
//   No producer warp: a 160-thread block is allotted registers as if it
//   had 192 threads, which at three blocks an SM left the masked
//   instantiations spilling.
// - S = Q K^T and dP = dO V^T are D / 16 `wgmma` m64n64k16 each, from
//   shared memory with both operands K-major. p and dS are computed on the
//   accumulator fragment: a thread holds rows r and r + 8, whose lse and
//   delta it reads once. Tiles the mask keeps whole skip the mask.
// - dQ += dS K takes dS from registers, packed in the accumulator's own
//   order (as the forward packs P), and K as the MN-major operand (the
//   transpose bit), as the forward reads V. dS is split into two bf16
//   parts, hi = bf16(dS) and lo = bf16(dS - hi), each a product into the
//   same fp32 accumulator: rounding dS once to bf16 would leave each term
//   off by up to 2^-9 of itself, which summed over a thousand keys is
//   several times the card tests' limit on elements near 0; hi + lo keeps
//   about 2^-17. So the kernel runs 4 products a tile where the TPU's runs
//   3, and holds the reference's fp32 dS.
// The FMA kernel (`flash_bwd_dq_kernel`), 256 threads: products as fp32
// FMAs from shared memory, for the fp32 and fp16 models and checks, and for
// every io type at head_dim 256 (in two 32-row passes, DqFma) and, split
// over the head_dim in 256-column chunks of dQ (SPLIT), above it.
//
// Grid: FMA (ceil(Sq / 64), heads, head_dim / 256 above 256); bf16 the
// same for the fixed-length mask and (heads, ceil(Sq / 64)) for the varlen
// and flashmask masks, the query tiles last to first (the longest first
// under a causal mask); at most 65535 heads a launch (by_head_slices).
#include "flash_common.cuh"
#include "hopper.cuh"

#include <type_traits>

namespace pt_flash {

// Query rows a pass of the FMA dQ kernel holds: the whole 64-row tile up to
// D = 128; at D = 256 two passes of 32 rows, so that the fp32 Q, dO, K and V
// tiles fit one block's shared memory (64-row ones would take 280,320
// bytes of the 232,448 a block may have). The mask still works on 64-row
// tiles: a pass visits every key tile its query tile visits.
template <int D>
struct DqFma {
  static constexpr int RI = D > 128 ? 2 : 4;  // 16-row groups a pass
  static constexpr int QR = 16 * RI;          // query rows a pass
  static constexpr size_t SMEM =
      sizeof(float) * (2 * QR * (D + 1) + 2 * BK * (D + 1) + QR * LDP + 2 * QR);
};

// SPLIT (head_dim above 256, D = 256): the tensors' head_dim is
// gridDim.z * D and the block writes the D-column chunk blockIdx.z of dQ.
// S and dP still take the whole head_dim: for each key tile the block
// streams Q, dO, K and V through their tiles chunk by chunk, its own chunk
// last, so that Ks holds the chunk of K that dQ's product reads.
template <typename T, int D, typename Mask, bool SPLIT = false>
// Shared memory allows two blocks per SM at head_dim <= 64 (one at 128 and
// 256): saying so keeps ptxas from squeezing the kernel into 64 registers
// with spills to reach an occupancy the shared memory rules out.
__global__ void __launch_bounds__(NT, D > 128 ? 1 : 2)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, Layout lay,
                    Mask heads_mask, float scale) {
  constexpr int LD = D + 1;
  constexpr int DJ = D / 16;
  constexpr int RI = DqFma<D>::RI, QR = DqFma<D>::QR;
  extern __shared__ float smem[];
  float* Qs = smem;            // [QR][LD]
  float* dOs = Qs + QR * LD;   // [QR][LD]
  float* Ks = dOs + QR * LD;   // [BK][LD]
  float* Vs = Ks + BK * LD;    // [BK][LD]
  float* dSs = Vs + BK * LD;   // [QR][LDP]
  float* Ls = dSs + QR * LDP;  // [QR]
  float* Dl = Ls + QR;         // [QR]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int h = blockIdx.y;
  const Mask mask = heads_mask.at_head(h);
  const int qt = blockIdx.x;
  const int cz = SPLIT ? blockIdx.z : 0;  // the output chunk
  const int nch = SPLIT ? gridDim.z : 1;
  const T* qb = q + h * lay.q_hs;
  const T* dob = dout + h * lay.q_hs;
  const T* kb = k + h * lay.k_hs;
  const T* vb = v + h * lay.k_hs;
  const int2 tiles = mask.key_tiles(qt);

  for (int q0 = qt * BQ; q0 < min(qt * BQ + BQ, lay.sq); q0 += QR) {
    __syncthreads();  // the last pass's reads of Qs, dOs, Ls and Dl are done
    if (!SPLIT) {
      load_tile<T, QR, D>(Qs, qb, q0, lay.sq, lay.q_rs);
      load_tile<T, QR, D>(dOs, dob, q0, lay.sq, lay.q_rs);
    }
    load_rowvec(Ls, lse + (size_t)h * lay.sq, q0, lay.sq, QR);
    load_rowvec(Dl, delta + (size_t)h * lay.sq, q0, lay.sq, QR);

    float dq_acc[RI][DJ];
    RowInfo qi[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      qi[i] = mask.q_row(q0 + ty + 16 * i);
#pragma unroll
      for (int c = 0; c < DJ; ++c) dq_acc[i][c] = 0.f;
    }

    for (int j = tiles.x; j < tiles.y; ++j) {
      if (!mask.tile_open(qt, j)) continue;  // the same for the whole block
      const int k0 = j * BK;
      RowInfo ki[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) ki[b] = mask.k_row(k0 + tx + 16 * b);
      // s = Q K^T and dP = dO V^T; thread holds query rows ty + 16 i, keys tx + 16 b
      float s[RI][4], dp[RI][4];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int b = 0; b < 4; ++b) s[i][b] = dp[i][b] = 0.f;
      // one pass over the head_dim unless SPLIT: then chunk cc, this block's last
      for (int n = 1; n <= nch; ++n) {
        const int cc = SPLIT ? (cz + n) % nch : 0;
        __syncthreads();  // the last reads of Qs, dOs, Ks, Vs and dSs are done
        if (SPLIT) {
          load_tile<T, QR, D>(Qs, qb + cc * D, q0, lay.sq, lay.q_rs);
          load_tile<T, QR, D>(dOs, dob + cc * D, q0, lay.sq, lay.q_rs);
        }
        load_tile<T, BK, D>(Ks, kb + cc * D, k0, lay.sk, lay.k_rs);
        load_tile<T, BK, D>(Vs, vb + cc * D, k0, lay.sk, lay.k_rs);
        __syncthreads();
#pragma unroll 4
        for (int d = 0; d < D; ++d) {
          float qa[RI], oa[RI], kv[4], vv[4];
#pragma unroll
          for (int i = 0; i < RI; ++i) {
            qa[i] = Qs[(ty + 16 * i) * LD + d];
            oa[i] = dOs[(ty + 16 * i) * LD + d];
          }
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            kv[b] = Ks[(tx + 16 * b) * LD + d];
            vv[b] = Vs[(tx + 16 * b) * LD + d];
          }
#pragma unroll
          for (int i = 0; i < RI; ++i)
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              s[i][b] = fmaf(qa[i], kv[b], s[i][b]);
              dp[i][b] = fmaf(oa[i], vv[b], dp[i][b]);
            }
        }
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
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
        float sa[RI], kr[DJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) sa[i] = dSs[(ty + 16 * i) * LDP + kk];
#pragma unroll
        for (int c = 0; c < DJ; ++c) kr[c] = Ks[kk * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int c = 0; c < DJ; ++c) dq_acc[i][c] = fmaf(sa[i], kr[c], dq_acc[i][c]);
      }
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qp = q0 + ty + 16 * i;
      if (qp >= lay.sq) continue;
      T* row = dq + h * lay.q_hs + qp * lay.q_rs + cz * D;
#pragma unroll
      for (int c = 0; c < DJ; ++c) row[tx + 16 * c] = from_f<T>(dq_acc[i][c]);
    }
  }
}

// ------------------------------------------------ the bf16 tensor-core kernel

// The bf16 kernel's shared memory: the Q and dO tiles, then STAGES (K, V)
// stages, then the mbarriers (1024 bytes of slack to align the tiles).
template <int D>
struct DqRing {
  static constexpr int STAGES = 2;
  static constexpr size_t SMEM = 1024 + (size_t)HopTile<D>::BYTES * (2 + 2 * STAGES) +
                                 sizeof(uint64_t) * (1 + STAGES);
};

// One key tile's dS on the S accumulator `sc` (rows r and r + 8 of the
// tile: h2 = 0, 1), from dP in `dp`: p = exp(s scale - lse) under the mask,
// dS = p (dP - delta) scale, left in `sc`. lse2 is lse * log2(e). FULL:
// the mask keeps every pair of the tile, so no element is tested.
template <bool FULL, typename Mask>
__device__ __forceinline__ void dq_ds_tile(const Mask& mask, int j, const RowInfo (&qi)[2],
                                           int cq, float scale, const float (&lse2)[2],
                                           const float (&dl)[2], float (&sc)[32],
                                           const float (&dp)[32]) {
  const float scale_log2 = scale * LOG2E;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      RowInfo ki{};
      if (!FULL) ki = mask.k_row(j * BK + 8 * jj + cq + e);
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int i = 4 * jj + 2 * h2 + e;
        float p = exp2_ftz(fmaf(sc[i], scale_log2, -lse2[h2]));
        if (!FULL && !mask.visible(qi[h2], ki)) p = 0.f;
        sc[i] = p * (dp[i] - dl[h2]) * scale;
      }
    }
}

template <int D, typename Mask>
__global__ void __launch_bounds__(HOP_CONSUMERS, D == 128 ? 2 : 4)
flash_bwd_dq_hopper(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, Layout lay,
                    Mask heads_mask, float scale, int packed, int tiles_x) {
  using Tile = HopTile<D>;
  constexpr int STAGES = DqRing<D>::STAGES;
  using namespace pt_hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align_1024(smem_raw);
  uint8_t* dOs = Qs + Tile::BYTES;
  uint8_t* KVs = dOs + Tile::BYTES;  // stage s: K at 2 s tiles on, V one tile after
  uint64_t* q_full = reinterpret_cast<uint64_t*>(KVs + 2 * STAGES * Tile::BYTES);
  uint64_t* full = q_full + 1;

  const int h = tiles_x ? blockIdx.y : blockIdx.x;
  const int qt = tiles_x ? gridDim.x - 1 - blockIdx.x : gridDim.y - 1 - blockIdx.y;
  const int q0 = qt * BQ;
  const Mask mask = heads_mask.at_head(h);
  const int2 tiles = mask.key_tiles(qt);
  // the key tiles visited, in order: the loads and the products walk the
  // same list
  auto next_tile = [&](int j) {
    for (++j; j < tiles.y && !mask.tile_open(qt, j); ++j) {
    }
    return j;
  };
  const int t = threadIdx.x;
  // key tile j into ring stage s: thread 0 issues the TMA loads
  auto load_stage = [&](int s, int j) {
    if (t == 0) {
      mbar_arrive_expect_tx(full + s, 2 * Tile::BYTES);
      uint8_t* Ks = KVs + 2 * s * Tile::BYTES;
      tma_tile<D>(Ks, &tm_k, full + s, j * BK, h, packed);
      tma_tile<D>(Ks + Tile::BYTES, &tm_v, full + s, j * BK, h, packed);
    }
  };

  if (t == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) mbar_init(full + s, 1);
    mbar_fence_init();
    tma_prefetch_map(&tm_q);
    tma_prefetch_map(&tm_do);
    tma_prefetch_map(&tm_k);
    tma_prefetch_map(&tm_v);
  }
  __syncthreads();
  if (t == 0) {
    mbar_arrive_expect_tx(q_full, 2 * Tile::BYTES);
    tma_tile<D>(Qs, &tm_q, q_full, q0, h, packed);
    tma_tile<D>(dOs, &tm_do, q_full, q0, h, packed);
  }
  int fill = next_tile(tiles.x - 1);  // the next key tile to load
  for (int s = 0; s < STAGES && fill < tiles.y; ++s, fill = next_tile(fill)) load_stage(s, fill);

  // Thread t holds rows r and r + 8 of the tile and, of each 8 columns of
  // S, dP or dQ, the pair at 2 * (t % 4).
  const int r = 16 * (t / 32) + (t % 32) / 4;
  const int cq = 2 * (t % 4);
  const uint32_t q_addr = smem_u32(Qs), do_addr = smem_u32(dOs);
  auto k_addr = [&](int s) { return smem_u32(KVs + 2 * s * Tile::BYTES); };

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const RowInfo qi[2] = {mask.q_row(q0 + r), mask.q_row(q0 + r + 8)};
  float lse2[2], dl[2];  // 0 past the last row, which is never written
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int qp = q0 + r + 8 * h2;
    lse2[h2] = qp < lay.sq ? lse[(size_t)h * lay.sq + qp] * LOG2E : 0.f;
    dl[h2] = qp < lay.sq ? delta[(size_t)h * lay.sq + qp] : 0.f;
  }

  mbar_wait(q_full, 0);
  int it = 0;
  for (int j = next_tile(tiles.x - 1); j < tiles.y; j = next_tile(j), ++it) {
    const int s = it % STAGES;
    // S and dP are this tile's alone: set here, so that no value of them
    // stays live across the loop (the products' operands read them)
    float sc[32], dp[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) sc[x] = dp[x] = 0.f;
    mbar_wait(full + s, (it / STAGES) & 1);
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
    wgmma_nt<D>(sc, q_addr, k_addr(s));                 // S = Q K^T
    wgmma_nt<D>(dp, do_addr, k_addr(s) + Tile::BYTES);  // dP = dO V^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    if (mask.tile_full(qt, j))
      dq_ds_tile<true>(mask, j, qi, cq, scale, lse2, dl, sc, dp);
    else
      dq_ds_tile<false>(mask, j, qi, cq, scale, lse2, dl, sc, dp);
    // dS as the A operand, hi and lo parts: its k-th 16 keys are values
    // 8k .. 8k + 7
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        pack_bf16_split(sc[8 * k + 2 * x], sc[8 * k + 2 * x + 1], ah[k][x], al[k][x]);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // dQ += dS K
      wgmma_rs_d<D>(acc, ah[k], Tile::mn_major(k_addr(s), k));
      wgmma_rs_d<D>(acc, al[k], Tile::mn_major(k_addr(s), k));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      fence_regs(ah[k]);
      fence_regs(al[k]);
    }
    if (fill < tiles.y) {  // the same for the whole block
      __syncthreads();       // every thread's products have read stage s
      load_stage(s, fill);
      fill = next_tile(fill);
    }
  }

#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int qp = q0 + r + 8 * h2;
    if (qp >= lay.sq) continue;
    __nv_bfloat16* row = dq + h * lay.q_hs + (long long)qp * lay.q_rs + cq;
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * jd) =
          __floats2bfloat162_rn(acc[4 * jd + 2 * h2], acc[4 * jd + 2 * h2 + 1]);
  }
}

template <int D, typename Mask>
cudaError_t dq_hopper(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int heads, Layout lay,
                      Mask mask, float scale, int packed, void* stream) {
  const int nqt = (lay.sq + BQ - 1) / BQ;
  // as the forward's grid (fwd_hopper): one head's tiles side by side for
  // the fixed-length mask, the heads side by side for the others
  const int tiles_x = std::is_same<Mask, CausalMask>::value;
  const dim3 grid = tiles_x ? dim3(nqt, heads) : dim3(heads, nqt);
  if (grid.y > 65535 || heads < 1 || nqt < 1) return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mdo;
  int err = hop_map<D>(&mq, q, lay.sq, heads, lay.q_rs, lay.q_hs, packed);
  if (!err) err = hop_map<D>(&mdo, dout, lay.sq, heads, lay.q_rs, lay.q_hs, packed);
  if (!err) err = hop_map<D>(&mk, k, lay.sk, heads, lay.k_rs, lay.k_hs, packed);
  if (!err) err = hop_map<D>(&mv, v, lay.sk, heads, lay.k_rs, lay.k_hs, packed);
  if (err) return (cudaError_t)err;
  return launch_nt(flash_bwd_dq_hopper<D, Mask>, grid, HOP_CONSUMERS, DqRing<D>::SMEM, stream, mq, mk,
                   mv, mdo, (const float*)lse, (const float*)delta, (__nv_bfloat16*)dq, lay, mask,
                   scale, packed, tiles_x);
}

// ------------------------------------------------------ launch and entries

// `chunks` > 1: the SPLIT kernel, one block per 256-column chunk of dQ.
template <typename T, int D, typename Mask, bool SPLIT = false>
cudaError_t dq_launch(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int heads, Layout lay,
                      Mask mask, float scale, void* stream, int chunks = 1) {
  const dim3 grid((lay.sq + BQ - 1) / BQ, heads, chunks);
  return launch(flash_bwd_dq_kernel<T, D, Mask, SPLIT>, grid, DqFma<D>::SMEM, stream,
                (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
                (const float*)delta, (T*)dq, lay, mask, scale);
}

// bf16 to the tensor-core kernel, float and fp16 to the FMA kernel (io:
// see Io); head_dim 256 to the FMA kernel at every io type, and a head_dim
// above 256 (a multiple of 256: the wrappers pad to it) to the FMA kernel
// split over it. `packed` says the tensors are [T, H, D] (varlen) rather
// than [BH, S, D]. One slice of at most MAX_GRID_Y heads.
template <typename Mask>
cudaError_t dq_heads(int d, int io, const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta, void* dq, int heads,
                     Layout lay, Mask mask, float scale, int packed, void* stream) {
  if (d > 256) {
    if (d % 256) return cudaErrorInvalidValue;
    PT_FLASH_SWITCH_IO(io, return dq_launch<T, 256, Mask, true>(q, k, v, dout, lse, delta, dq,
                                                                heads, lay, mask, scale, stream,
                                                                d / 256))
  }
  if (d == 256) {
    PT_FLASH_SWITCH_IO(io, return dq_launch<T, 256>(q, k, v, dout, lse, delta, dq, heads, lay,
                                                    mask, scale, stream))
  }
  if (io == IO_BF16) {
    PT_FLASH_SWITCH_D(d, return dq_hopper<D>(q, k, v, dout, lse, delta, dq, heads, lay, mask,
                                             scale, packed, stream))
  }
  PT_FLASH_SWITCH_D(d, PT_FLASH_SWITCH_FMA_IO(io, return dq_launch<T, D>(
                                                      q, k, v, dout, lse, delta, dq, heads, lay,
                                                      mask, scale, stream)))
}

// dq_heads over every slice of the heads (by_head_slices).
template <typename Mask>
cudaError_t dq_any(int d, int io, const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta, void* dq, int heads,
                   Layout lay, Mask mask, float scale, int packed, void* stream) {
  const long long e = io_bytes(io);
  return by_head_slices(heads, [&](int h0, int n) {
    const long long rows = (long long)h0 * lay.sq;
    return dq_heads(d, io, at(q, h0 * lay.q_hs, e), at(k, h0 * lay.k_hs, e),
                    at(v, h0 * lay.k_hs, e), at(dout, h0 * lay.q_hs, e), at(lse, rows, 4),
                    at(delta, rows, 4), at(dq, h0 * lay.q_hs, e), n, lay, mask.from_head(h0),
                    scale, packed, stream);
  });
}

}  // namespace pt_flash

// Every entry: io 0 float, 1 bf16, 2 fp16 (pt_flash::Io); bf16 q, k, v and
// dout start on 16-byte boundaries (their tensor maps need it; the
// wrappers see to it); a failed tensor-map encode returns the error code
// of libcuda, a refused launch cudaGetLastError().
//
// q, dout, dq [bh, sq, d] and k, v [bh, sk, d] in the io type, contiguous;
// lse and delta float [bh, sq]. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int pt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, void* dq, int bh, int sq,
                               int sk, int d, int io, int causal, float scale, int kv_len,
                               int q_offset, void* stream) {
  const pt_flash::CausalMask mask{sq, causal, kv_len, q_offset};
  return (int)pt_flash::dq_any(d, io, q, k, v, dout, lse, delta, dq, bh,
                               pt_flash::dense_layout(sq, sk, d), mask, scale, 0, stream);
}

// q, dout, dq [tq, h, d] and k, v [tk, h, d] in the io type, contiguous; lse
// and delta float [h, tq]; seg/pos and lo/hi as for pt_varlen_fwd. Launches
// on `stream` and returns cudaGetLastError().
extern "C" int pt_varlen_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dq, const int* seg_q,
                                const int* pos_q, const int* seg_k, const int* pos_k,
                                const int* lo, const int* hi, int h, int tq, int tk, int d,
                                int io, int causal, float scale, void* stream) {
  const pt_flash::SegmentMask mask{seg_q, pos_q, seg_k, pos_k, lo, hi, causal};
  return (int)pt_flash::dq_any(d, io, q, k, v, dout, lse, delta, dq, h,
                               pt_flash::packed_layout(tq, tk, h, d), mask, scale, 1, stream);
}

// q, dout, dq [bh, sq, d] and k, v [bh, sk, d] in the io type, contiguous;
// lse and delta float [bh, sq]; st/en/st_max/en_min as for
// pt_flashmask_fwd. Launches on `stream` and returns cudaGetLastError().
extern "C" int pt_flashmask_bwd_dq(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   void* dq, const int* st, const int* en, const int* st_max,
                                   const int* en_min, int bh, int h, int hs, int sq, int sk,
                                   int d, int io, int causal, float scale, void* stream) {
  const pt_flash::StartEndMask mask{st, en, st_max, en_min, h, hs, sq, sk, causal};
  return (int)pt_flash::dq_any(d, io, q, k, v, dout, lse, delta, dq, bh,
                               pt_flash::dense_layout(sq, sk, d), mask, scale, 0, stream);
}
