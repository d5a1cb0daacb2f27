// Flash-attention backward, dQ, for Hopper (sm_90a): fixed-length causal
// batches, packed variable-length sequences and flashmask (start/end row)
// masks, two kernels templated on the mask: a tensor-core kernel for bf16
// and fp16 io (`flash_bwd_dq_hopper`, templated on the 2-byte io type too)
// and an fp32 FMA kernel for float io (`flash_bwd_dq_kernel`). `dq_any`
// picks one by the io type. The tensor-core kernel has two forms: head_dim
// 32, 64 and 128 (one warpgroup, 64 query rows a block) and head_dim 256
// (two warpgroups, 128 rows a block, `dq_wide`); a head_dim above 256 (a
// multiple of 256: the wrappers pad to it) runs either kernel's 256 form
// split over it (SPLIT): one block per
// 256-column chunk of dQ, S and dP over the whole head_dim recomputed by
// every chunk's block.
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
// The tensor-core kernel (`flash_bwd_dq_hopper`), one block per (head,
// 64-row query tile), one warpgroup (128 threads), four blocks an SM below
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
//   transpose bit), as the forward reads V. dS is split into two parts of
//   the io type, hi = T(dS) and lo = T(dS - hi), each a product into the
//   same fp32 accumulator: rounding dS once to bf16 would leave each term
//   off by up to 2^-9 of itself, which summed over a thousand keys is
//   several times the card tests' limit on elements near 0; hi + lo keeps
//   about 2^-17. So the kernel runs 4 products a tile where the TPU's runs
//   3, and holds the reference's fp32 dS.
// - fp16 io: the same design and products (f16 operands, same rate). One
//   fp16 rounding of dS misses the fp16 limit (8x tighter) as bf16's misses
//   its own, so the split stays; but below 2^-14 fp16 is subnormal and
//   hi + lo then keeps only an absolute 2^-25. So each query row of dS is
//   scaled by a power of two of its own that puts the row's largest |dS|
//   in [2^14, 2^15) (`ds_rows`, shared with dK/dV: dS follows dO's scale,
//   2^-12 and 2^8 of unit scale alike under a loss scaler), lowered as
//   larger values come and the dQ rows summed so far rescaled with it; the
//   epilogue divides it out, exactly. dQ reads no P, so nothing else is
//   scaled.
// The FMA kernel (`flash_bwd_dq_kernel`), 256 threads: products as fp32
// FMAs from shared memory, for the fp32 models and checks, at
// head_dim 256 in two 32-row passes (DqFma) and, split over the head_dim
// in 256-column chunks of dQ (SPLIT), above it.
//
// The tensor-core kernel at head_dim 256 (`dq_wide`), one block per (head,
// 128-row query block, 256-column chunk of dQ), 256 threads: two consumer
// warpgroups, one per 64-row query tile, the forward's `fwd_wide` shape.
// What bounds it at the fixed-length shape (BH = 128, S = 1024, D = 256,
// causal): 1.0e11 FLOP (104 us) against 337 MB (100 us): the operations,
// barely; with dS's hi and lo it runs 4 products a tile where the bound
// counts 3.
// - Registers: a consumer thread holds dQ (128 fp32), S and dP (32 each)
//   at the S and dP products, then dS packed as hi and lo A fragments (32);
//   ptxas gives 232-244 registers, no spill, one block an SM. No producer
//   warp (flash_common.cuh: a third warpgroup's worth of registers);
//   thread 0 issues the TMA loads from `take` (WideRing), its issuing
//   state in shared memory so that no thread holds it in registers.
// - Shared memory, the forward's seven 32 KB buffers (WideSmem): Q and dO
//   of both query tiles resident at D = 256 (four buffers), K and V
//   through a 3-slot ring; above 256 all seven are the ring, and per key
//   tile and chunk Q and dO of both tiles stream beside K and V (L2 holds
//   them). Per key tile the fills are, chunk by chunk with the block's own
//   chunk last, [Q_c, Q_c', dO_c, dO_c',] V_c, K_c: K of the own chunk
//   stays in its slot until dQ += dS K is done, V goes after dP.
// - The two query tiles visit different key tiles: the ring holds the
//   union, as in `fwd_wide`, and a warpgroup that does not visit a tile
//   still takes it and hands it back.
// - Products a key tile and warpgroup: S and dP (16 `wgmma` m64n64k16
//   each per chunk), then dQ += dS K as 4 m64n256k16 for hi and 4 for lo,
//   K MN-major.
//
// Grid: FMA (ceil(Sq / 64), heads, head_dim / 256 above 256); tensor cores
// below 256 the same for the fixed-length mask and (heads, ceil(Sq / 64))
// for the varlen and flashmask masks, the query tiles last to first (the
// longest first under a causal mask); tensor cores at 256 and above
// (ceil(Sq / 128) * chunks, heads) or (heads, ceil(Sq / 128) * chunks), the
// chunk varying fastest; at most 65535 heads a launch (by_head_slices).
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
template <int D, typename Mask, bool SPLIT = false>
// Shared memory allows two blocks per SM at head_dim <= 64 (one at 128 and
// 256): saying so keeps ptxas from squeezing the kernel into 64 registers
// with spills to reach an occupancy the shared memory rules out.
__global__ void __launch_bounds__(NT, D > 128 ? 1 : 2)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, Layout lay, Mask heads_mask, float scale) {
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
  const float* qb = q + h * lay.q_hs;
  const float* dob = dout + h * lay.q_hs;
  const float* kb = k + h * lay.k_hs;
  const float* vb = v + h * lay.k_hs;
  const int2 tiles = mask.key_tiles(qt);

  for (int q0 = qt * BQ; q0 < min(qt * BQ + BQ, lay.sq); q0 += QR) {
    __syncthreads();  // the last pass's reads of Qs, dOs, Ls and Dl are done
    if (!SPLIT) {
      load_tile<QR, D>(Qs, qb, q0, lay.sq, lay.q_rs);
      load_tile<QR, D>(dOs, dob, q0, lay.sq, lay.q_rs);
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
          load_tile<QR, D>(Qs, qb + cc * D, q0, lay.sq, lay.q_rs);
          load_tile<QR, D>(dOs, dob + cc * D, q0, lay.sq, lay.q_rs);
        }
        load_tile<BK, D>(Ks, kb + cc * D, k0, lay.sk, lay.k_rs);
        load_tile<BK, D>(Vs, vb + cc * D, k0, lay.sk, lay.k_rs);
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
      float* row = dq + h * lay.q_hs + qp * lay.q_rs + cz * D;
#pragma unroll
      for (int c = 0; c < DJ; ++c) row[tx + 16 * c] = dq_acc[i][c];
    }
  }
}

// ------------------------------------------ the bf16 and fp16 tensor-core kernel

// The tensor-core kernel's shared memory: the Q and dO tiles, then STAGES (K, V)
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

// The one-warpgroup form (head_dim 32, 64, 128), io type T.
template <int D, typename T, typename Mask>
__device__ __forceinline__ void dq_narrow(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                                          const CUtensorMap& tm_v, const CUtensorMap& tm_do,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ delta,
                                          T* __restrict__ dq, const Layout& lay,
                                          const Mask& heads_mask, float scale, int packed,
                                          int tiles_x) {
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
  float ds_mul[2] = {DS_MUL_MAX, DS_MUL_MAX};  // fp16: ds_rows' powers

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
    wgmma_nt<D, T>(sc, q_addr, k_addr(s));                 // S = Q K^T
    wgmma_nt<D, T>(dp, do_addr, k_addr(s) + Tile::BYTES);  // dP = dO V^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    if (mask.tile_full(qt, j))
      dq_ds_tile<true>(mask, j, qi, cq, scale, lse2, dl, sc, dp);
    else
      dq_ds_tile<false>(mask, j, qi, cq, scale, lse2, dl, sc, dp);
    if constexpr (pt_hopper::is_f16<T>) ds_rows(sc, ds_mul, acc);
    // dS as the A operand, hi and lo parts: its k-th 16 keys are values
    // 8k .. 8k + 7
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        pack_split<T>(sc[8 * k + 2 * x], sc[8 * k + 2 * x + 1], ah[k][x], al[k][x]);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // dQ += dS K
      wgmma_rs_d<D, T>(acc, ah[k], Tile::mn_major(k_addr(s), k));
      wgmma_rs_d<D, T>(acc, al[k], Tile::mn_major(k_addr(s), k));
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
    T* row = dq + h * lay.q_hs + (long long)qp * lay.q_rs + cq;
    // fp16: the power the products were scaled by, divided out
    float mul = 1.f;
    if constexpr (pt_hopper::is_f16<T>) mul = 1.f / ds_mul[h2];
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd)
      *reinterpret_cast<uint32_t*>(row + 8 * jd) =
          pack2<T>(acc[4 * jd + 2 * h2] * mul, acc[4 * jd + 2 * h2 + 1] * mul);
  }
}

// The head_dim-256 form: 128 query rows (two 64-row tiles, one per
// consumer warpgroup) of head h and the 256-column chunk cz of dQ of
// `chunks` (SPLIT; 1 otherwise), io type T. See the notes at the top of
// the file.
template <typename T, typename Mask, bool SPLIT>
__device__ __forceinline__ void dq_wide(const CUtensorMap* tm_q, const CUtensorMap* tm_k,
                                        const CUtensorMap* tm_v, const CUtensorMap* tm_do,
                                        const float* __restrict__ lse,
                                        const float* __restrict__ delta,
                                        T* __restrict__ dq, const Layout& lay,
                                        const Mask& heads_mask, float scale, int packed,
                                        int tiles_x, int chunks) {
  using Tile = HopTile<256>;
  using namespace pt_hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* bufs = align_1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(bufs + WideSmem::BARRIERS);

  const int n = SPLIT ? chunks : 1;
  const bool q_res = n == 1;  // Q and dO of both tiles resident; else streamed
  const int q_bufs = q_res ? 4 : 0;
  const int per_chunk = q_res ? 2 : 6;  // fills of a chunk: [Q, Q', dO, dO',] V, K

  // as fwd_wide: the grid's tile axis holds (query block, chunk), the chunk
  // fastest; query blocks last to first, the longest first under a causal
  // mask
  const int h = tiles_x ? blockIdx.y : blockIdx.x;
  const int tile = tiles_x ? blockIdx.x : blockIdx.y;
  const int ext = tiles_x ? gridDim.x : gridDim.y;
  const int cz = SPLIT ? tile % n : 0;
  const int qb = ext / n - 1 - tile / n;
  const int q0 = qb * WIDE_BQ;
  const int nqt = (lay.sq + BQ - 1) / BQ;
  const Mask mask = heads_mask.at_head(h);

  // key tiles [x, y) of query tiles 2 qb and 2 qb + 1 (none past the end),
  // and the block's list: every key tile either visits, in order (as in
  // fwd_wide)
  const int2 rng0 = 2 * qb < nqt ? mask.key_tiles(2 * qb) : make_int2(0, 0);
  const int2 rng1 = 2 * qb + 1 < nqt ? mask.key_tiles(2 * qb + 1) : make_int2(0, 0);
  const bool none0 = rng0.x >= rng0.y, none1 = rng1.x >= rng1.y;
  const int lo = none0 ? rng1.x : none1 ? rng0.x : min(rng0.x, rng1.x);
  const int hi = none0 ? rng1.y : none1 ? rng0.y : max(rng0.y, rng1.y);
  auto visits = [&](int w, int j) {
    const int2 rw = w ? rng1 : rng0;
    return j >= rw.x && j < rw.y && mask.tile_open(2 * qb + w, j);
  };
  auto next_tile = [&](int j) {
    for (++j; j < hi && !visits(0, j) && !visits(1, j); ++j) {
    }
    return j;
  };

  // The fills, per key tile of the list and per chunk, this block's own
  // chunk last (its K stays for dQ += dS K): [Q_c and dO_c of both query
  // tiles,] V_c, K_c.
  auto more = [&](const RingIssuer& is) { return is.tile < hi; };
  auto load = [&](RingIssuer& is, uint8_t* dst, uint64_t* bar) {
    const int c = (cz + 1 + is.fill / per_chunk) % n, sub = is.fill % per_chunk;
    const bool kv = sub + 2 >= per_chunk;
    const CUtensorMap* map = kv ? (sub + 2 == per_chunk ? tm_v : tm_k) : sub < 2 ? tm_q : tm_do;
    tma_tile<256>(dst, map, bar, kv ? is.tile * BK : q0 + (sub & 1) * BQ, h, packed, c * 256);
    if (++is.fill == per_chunk * n) {
      is.fill = 0;
      is.tile = next_tile(is.tile);
    }
  };
  auto ring = wide_ring(bufs, q_bufs, next_tile(lo - 1), more, load);
  if (threadIdx.x == 0) {
    tma_prefetch_map(tm_q);
    tma_prefetch_map(tm_do);
    tma_prefetch_map(tm_k);
    tma_prefetch_map(tm_v);
    if (q_res) {  // buffers: Q of tiles 0 and 1, then dO of tiles 0 and 1
      mbar_arrive_expect_tx(q_full, 4 * Tile::BYTES);
      for (int x = 0; x < 4; ++x)
        tma_tile<256>(bufs + x * Tile::BYTES, x < 2 ? tm_q : tm_do, q_full, q0 + (x & 1) * BQ, h,
                      packed);
    }
  }

  // A consumer warpgroup: query tile qt = 2 qb + w. Thread t holds rows r
  // and r + 8 of the tile and, of each 8 columns of S, dP or dQ, the pair
  // at 2 * (t % 4).
  const int w = threadIdx.x / HOP_CONSUMERS;
  const int t = threadIdx.x % HOP_CONSUMERS;
  const int qt = 2 * qb + w;
  const int r = 16 * (t / 32) + (t % 32) / 4;
  const int cq = 2 * (t % 4);
  const int row0 = q0 + w * BQ;

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  RowInfo qi[2] = {};
  float lse2[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};  // 0 past the last row, never written
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int qp = row0 + r + 8 * h2;
    if (qt < nqt) qi[h2] = mask.q_row(qp);
    if (qp < lay.sq) {
      lse2[h2] = lse[(size_t)h * lay.sq + qp] * LOG2E;
      dl[h2] = delta[(size_t)h * lay.sq + qp];
    }
  }
  float ds_mul[2] = {DS_MUL_MAX, DS_MUL_MAX};  // fp16: ds_rows' powers

  if (q_res) mbar_wait(q_full, 0);
#pragma unroll 1
  for (int j = next_tile(lo - 1); j < hi; j = next_tile(j)) {
    const bool mine = visits(w, j);
    // S and dP, fresh each tile: no value of them lives through dQ += dS K
    float sc[32], dp[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) sc[x] = dp[x] = 0.f;
    int ks = 0;  // the slot of this block's chunk of K
#pragma unroll 1
    for (int ci = 0; ci < n; ++ci) {
      int qs = 0, ds = 0;
      if (!q_res) {
        const int q0s = ring.take(), q1s = ring.take();
        const int d0s = ring.take(), d1s = ring.take();
        qs = w ? q1s : q0s;
        ds = w ? d1s : d0s;
        ring.release(w ? q0s : q1s);  // the other tile's: not read here
        ring.release(w ? d0s : d1s);
      }
      const int vs = ring.take();
      ks = ring.take();
      if (mine) {
        uint32_t q_addr = q_res ? smem_u32(bufs + w * Tile::BYTES) : ring.addr(qs);
        uint32_t do_addr = q_res ? smem_u32(bufs + (2 + w) * Tile::BYTES) : ring.addr(ds);
        // recomputed each tile: 32 descriptors kept across the loop would
        // hold registers the accumulators need
        asm volatile("" : "+r"(q_addr), "+r"(do_addr));
        fence_regs(sc);
        fence_regs(dp);
        wgmma_fence();
        wgmma_nt<256, T>(sc, q_addr, ring.addr(ks), ci > 0);  // S += Q_c K_c^T
        wgmma_nt<256, T>(dp, do_addr, ring.addr(vs), ci > 0);  // dP += dO_c V_c^T
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dp);
      }
      if (!q_res) {
        ring.release(qs);
        ring.release(ds);
      }
      ring.release(vs);
      if (ci + 1 < n) ring.release(ks);
    }
    if (mine) {
      if (mask.tile_full(qt, j))
        dq_ds_tile<true>(mask, j, qi, cq, scale, lse2, dl, sc, dp);
      else
        dq_ds_tile<false>(mask, j, qi, cq, scale, lse2, dl, sc, dp);
      if constexpr (pt_hopper::is_f16<T>) ds_rows(sc, ds_mul, acc);
      // dS as the A operand, hi and lo parts: its k-th 16 keys are values
      // 8k .. 8k + 7
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          pack_split<T>(sc[8 * k + 2 * x], sc[8 * k + 2 * x + 1], ah[k][x], al[k][x]);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k) {  // dQ += dS K_cz
        wgmma_rs_d<256, T>(acc, ah[k], Tile::mn_major(ring.addr(ks), k));
        wgmma_rs_d<256, T>(acc, al[k], Tile::mn_major(ring.addr(ks), k));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        fence_regs(ah[k]);
        fence_regs(al[k]);
      }
    }
    ring.release(ks);
  }
  // the fills the other warpgroup still takes
  if (threadIdx.x == 0) ring.issue(INT_MAX);

#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int qp = row0 + r + 8 * h2;
    if (qp >= lay.sq) continue;
    T* row = dq + h * lay.q_hs + (long long)qp * lay.q_rs + cz * 256 + cq;
    // fp16: the power the products were scaled by, divided out
    float mul = 1.f;
    if constexpr (pt_hopper::is_f16<T>) mul = 1.f / ds_mul[h2];
#pragma unroll
    for (int jd = 0; jd < 32; ++jd)
      *reinterpret_cast<uint32_t*>(row + 8 * jd) =
          pack2<T>(acc[4 * jd + 2 * h2] * mul, acc[4 * jd + 2 * h2 + 1] * mul);
  }
}

// The tensor-core kernel, io type T (bf16 or fp16): the one-warpgroup form
// below head_dim 256, the two-warpgroup form at 256 (SPLIT: one 256-column
// chunk of a wider head_dim, `chunks` of them).
template <int D, typename T, typename Mask, bool SPLIT = false>
__global__ void __launch_bounds__(D == 256 ? WIDE_NT : HOP_CONSUMERS,
                                  D == 256 ? 1 : D == 128 ? 2 : 4)
flash_bwd_dq_hopper(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, Layout lay,
                    Mask heads_mask, float scale, int packed, int tiles_x, int chunks) {
  static_assert(D == 256 || !SPLIT, "SPLIT is the head_dim-256 form's");
  if constexpr (D == 256)
    dq_wide<T, Mask, SPLIT>(&tm_q, &tm_k, &tm_v, &tm_do, lse, delta, dq, lay, heads_mask, scale,
                            packed, tiles_x, chunks);
  else
    dq_narrow<D, T, Mask>(tm_q, tm_k, tm_v, tm_do, lse, delta, dq, lay, heads_mask, scale,
                          packed, tiles_x);
}

template <int D, typename T, typename Mask>
cudaError_t dq_hopper(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int heads, Layout lay,
                      Mask mask, float scale, int packed, void* stream) {
  const int nqt = (lay.sq + BQ - 1) / BQ;
  // as the forward's grid (fwd_hopper): one head's tiles side by side for
  // the fixed-length mask, the heads side by side for the others
  // More than MAX_GRID_Y tiles go on x whatever the mask (x holds 2^31 - 1
  // blocks; by_head_slices keeps the heads on y within MAX_GRID_Y).
  const int tiles_x = std::is_same<Mask, CausalMask>::value || nqt > MAX_GRID_Y;
  const dim3 grid = tiles_x ? dim3(nqt, heads) : dim3(heads, nqt);
  if (heads < 1 || heads > MAX_GRID_Y || nqt < 1) return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mdo;
  int err = hop_map<D, T>(&mq, q, lay.sq, heads, lay.q_rs, lay.q_hs, packed);
  if (!err) err = hop_map<D, T>(&mdo, dout, lay.sq, heads, lay.q_rs, lay.q_hs, packed);
  if (!err) err = hop_map<D, T>(&mk, k, lay.sk, heads, lay.k_rs, lay.k_hs, packed);
  if (!err) err = hop_map<D, T>(&mv, v, lay.sk, heads, lay.k_rs, lay.k_hs, packed);
  if (err) return (cudaError_t)err;
  return launch_nt(flash_bwd_dq_hopper<D, T, Mask>, grid, HOP_CONSUMERS, DqRing<D>::SMEM, stream,
                   mq, mk, mv, mdo, (const float*)lse, (const float*)delta, (T*)dq, lay, mask,
                   scale, packed, tiles_x, 1);
}

// The head_dim-256 form over `chunks` 256-column chunks of the head_dim
// (SPLIT when more than one).
template <typename T, typename Mask, bool SPLIT>
cudaError_t dq_wide_launch(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dq, int heads, Layout lay,
                           Mask mask, float scale, int packed, void* stream, int chunks) {
  const long long nqb = (lay.sq + WIDE_BQ - 1) / WIDE_BQ;
  const long long ext = nqb * chunks;
  // as fwd_wide_launch: fixed-length blocks of one head side by side, the
  // varlen and flashmask heads side by side, more than MAX_GRID_Y on x
  const int tiles_x = std::is_same<Mask, CausalMask>::value || ext > MAX_GRID_Y;
  if (heads < 1 || heads > MAX_GRID_Y || nqb < 1 || ext > INT_MAX || (chunks > 1) != SPLIT)
    return cudaErrorInvalidValue;
  const dim3 grid = tiles_x ? dim3((unsigned)ext, heads) : dim3(heads, (unsigned)ext);
  const int d = 256 * chunks;
  CUtensorMap mq, mk, mv, mdo;
  int err = hop_map<256, T>(&mq, q, lay.sq, heads, lay.q_rs, lay.q_hs, packed, d);
  if (!err) err = hop_map<256, T>(&mdo, dout, lay.sq, heads, lay.q_rs, lay.q_hs, packed, d);
  if (!err) err = hop_map<256, T>(&mk, k, lay.sk, heads, lay.k_rs, lay.k_hs, packed, d);
  if (!err) err = hop_map<256, T>(&mv, v, lay.sk, heads, lay.k_rs, lay.k_hs, packed, d);
  if (err) return (cudaError_t)err;
  return launch_nt(flash_bwd_dq_hopper<256, T, Mask, SPLIT>, grid, WIDE_NT, WideSmem::SMEM, stream,
                   mq, mk, mv, mdo, (const float*)lse, (const float*)delta, (T*)dq, lay, mask,
                   scale, packed, tiles_x, chunks);
}

// ------------------------------------------------------ launch and entries

// The FMA kernel (float io); `chunks` > 1: the SPLIT kernel, one block per
// 256-column chunk of dQ.
template <int D, typename Mask, bool SPLIT = false>
cudaError_t dq_fma(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dq, int heads, Layout lay, Mask mask,
                   float scale, void* stream, int chunks = 1) {
  const dim3 grid((lay.sq + BQ - 1) / BQ, heads, chunks);
  return launch(flash_bwd_dq_kernel<D, Mask, SPLIT>, grid, DqFma<D>::SMEM, stream,
                (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
                (const float*)lse, (const float*)delta, (float*)dq, lay, mask, scale);
}

// bf16 and fp16 to the tensor-core kernel, float to the FMA kernel (io:
// see Io), chosen by io type at every head_dim; head_dim 256 to either
// kernel's 256 form, and a head_dim above 256 (a multiple of 256: the
// wrappers pad to it) to the same form split over it. `packed` says the
// tensors are [T, H, D] (varlen) rather than [BH, S, D]. One slice of at
// most MAX_GRID_Y heads.
template <typename Mask>
cudaError_t dq_heads(int d, int io, const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta, void* dq, int heads,
                     Layout lay, Mask mask, float scale, int packed, void* stream) {
  if (d >= 256) {
    if (d % 256) return cudaErrorInvalidValue;
    const int chunks = d / 256;
    if (io == IO_F32)
      return chunks == 1 ? dq_fma<256>(q, k, v, dout, lse, delta, dq, heads, lay, mask, scale,
                                       stream)
                         : dq_fma<256, Mask, true>(q, k, v, dout, lse, delta, dq, heads, lay,
                                                   mask, scale, stream, chunks);
    PT_FLASH_SWITCH_HOP_IO(
        io, return chunks == 1
                       ? dq_wide_launch<T, Mask, false>(q, k, v, dout, lse, delta, dq, heads, lay,
                                                        mask, scale, packed, stream, 1)
                       : dq_wide_launch<T, Mask, true>(q, k, v, dout, lse, delta, dq, heads, lay,
                                                       mask, scale, packed, stream, chunks))
  }
  if (io == IO_F32) {
    PT_FLASH_SWITCH_D(d, return dq_fma<D>(q, k, v, dout, lse, delta, dq, heads, lay, mask,
                                          scale, stream))
  }
  PT_FLASH_SWITCH_D(d, PT_FLASH_SWITCH_HOP_IO(io, return dq_hopper<D, T>(q, k, v, dout, lse,
                                                                         delta, dq, heads, lay,
                                                                         mask, scale, packed,
                                                                         stream)))
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

// Every entry: io 0 float, 1 bf16, 2 fp16 (pt_flash::Io); bf16 and fp16 q,
// k, v and dout start on 16-byte boundaries (their tensor maps need it; the
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
