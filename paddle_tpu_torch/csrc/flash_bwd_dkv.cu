// Flash-attention backward, dK and dV, for Hopper (sm_90a): fixed-length
// causal batches, packed variable-length sequences and flashmask (start/end
// row) masks, two kernels templated on the mask: a tensor-core kernel for
// bf16 io (`flash_bwd_dkv_hopper`) and an fp32 FMA kernel for float and
// fp16 io (`flash_bwd_dkv_kernel`). `dkv_any` picks one by the io type.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py `_dkv_kernel`
// (launched from `_bwd`; entry `pt_flash_bwd_dkv`, CausalMask),
// paddle_tpu/ops/pallas/flash_varlen.py `_v_dkv_kernel` (launched from
// `_varlen_bwd`; entry `pt_varlen_bwd_dkv`, SegmentMask) and flash_varlen.py
// `_fm_dkv_kernel` (launched from `_fm_bwd`; entry `pt_flashmask_bwd_dkv`,
// StartEndMask). Same function: for
// one key tile, loop over the query tiles the mask lets see it; recompute
// p = exp(s - lse) under the forward's mask, then dV += p^T dO,
// dP = dO V^T, dS = p (dP - delta) scale, dK += dS^T Q, all with fp32 p
// and dS; delta = rowsum(dO o) comes in precomputed. dK and dV are written
// once, in the io type; a key no query sees gets 0.
//
// What bounds it on the H100: four products over the kept pairs. At the
// fixed-length training shape (BH = 128, S = 1024, D = 64, bf16, causal)
// 3.4e10 FLOP (35 us at 989 TFLOP/s) against 102 MB of q, k, v, dO, lse,
// delta, dk and dv (30 us at 3.35 TB/s); at the packed shape (T = 8192,
// H = 16, ten causal documents) 4.8e10 FLOP (48 us) against 102 MB
// (30 us): the operations in both; at the flashmask shape (BH = 32,
// S = 4096, 5.3e6 kept pairs per head) 4.4e10 FLOP (44 us) against 102 MB
// (30 us): the operations. k and v stay on chip for the whole block, dK
// and dV accumulate in registers and never round-trip to device memory,
// and query tiles the mask rules out (above the diagonal, outside the key
// tile's segments, or banned by every column of the key tile) are never
// loaded.
//
// The bf16 kernel (`flash_bwd_dkv_hopper`), one block per (head, 64-row
// key tile), one warpgroup (128 threads).
// - Thread 0 loads the K and V tiles by TMA and streams (Q, dO) tile
//   pairs through a ring of STAGES shared-memory stages: the first STAGES
//   at the start, then each into the stage the block has just finished (a
//   block barrier says when). Beside each pair every thread stores one of
//   the query tile's 64 lse (times log2 e) and 64 delta values, read from
//   device memory a tile ahead, and arrives on the stage's "full" mbarrier
//   (thread 0 with the TMA's byte count). Loads and products walk the same
//   tiles, `query_tiles(kt)` then `tile_open`. No producer warp: a
//   160-thread block is allotted registers as if it had 192 threads, which
//   at two blocks an SM left D = 64 spilling.
// - The block computes the scores transposed, S^T = K Q^T and
//   dP^T = V dO^T (D / 16 `wgmma` m64n64k16 each, both operands K-major
//   from shared memory), so that P^T and dS^T land in the A-operand layout
//   of the next products: a thread holds key rows r and r + 8 and, of each
//   8 query columns, the pair at 2 * (t % 4), whose lse and delta it reads
//   from the stage. Tiles the mask keeps whole skip the mask.
// - dV += P^T dO and dK += dS^T Q take P^T and dS^T from registers and dO
//   and Q as MN-major operands (the transpose bit), as the forward's P V.
//   P and dS are each split into two bf16 parts, hi = bf16(x) and
//   lo = bf16(x - hi), each a product into the same fp32 accumulator:
//   rounding them once to bf16 would leave each term off by up to 2^-9 of
//   itself, which summed over a thousand queries is several times the card
//   tests' limit on elements near 0; hi + lo keeps about 2^-17. So the
//   kernel runs 6 products a tile where the TPU's runs 4, and holds the
//   reference's fp32 P and dS.
// - Registers: S^T and dP^T (32 each), dK and dV (D / 2 each) and the
//   A operands (16 for each of P hi, P lo, dS hi, dS lo) a thread; D <= 64
//   runs two blocks an SM (up to 255 registers a thread), D = 128 one.
// The FMA kernel (`flash_bwd_dkv_kernel`), 256 threads: products as fp32
// FMAs from shared memory, for the fp32 and fp16 models and checks, and for
// every io type at head_dim 256 (in two 32-key passes, DkvFma) and, split
// over the head_dim in 256-column chunks of dK and dV (SPLIT), above it.
//
// Grid: FMA (ceil(Sk / 64), heads, head_dim / 256 above 256); bf16 the
// same for the fixed-length mask and (heads, ceil(Sk / 64)) for the varlen
// and flashmask masks, the key tiles first to last (the longest first
// under a causal mask); at most 65535 heads a launch (by_head_slices).
#include "flash_common.cuh"
#include "hopper.cuh"

#include <type_traits>

namespace pt_flash {

// Key rows a pass of the FMA dK/dV kernel holds: the whole 64-row tile up to
// D = 128; at D = 256 two passes of 32 rows, so that the fp32 K, V, Q and dO
// tiles fit one block's shared memory (64-row ones would take 296,960
// bytes of the 232,448 a block may have) and the dK and dV sums fit the
// registers. The mask still works on 64-row tiles: a pass visits every
// query tile its key tile visits.
template <int D>
struct DkvFma {
  static constexpr int KI = D > 128 ? 2 : 4;  // 16-key groups a pass
  static constexpr int KR = 16 * KI;          // keys a pass
  static constexpr int LDS = KR + 1;          // stride of a [64 x KR] score tile
  static constexpr size_t SMEM =
      sizeof(float) * (2 * KR * (D + 1) + 2 * BQ * (D + 1) + 2 * BQ * LDS + 2 * BQ);
};

// SPLIT (head_dim above 256, D = 256): the tensors' head_dim is
// gridDim.z * D and the block writes the D-column chunk blockIdx.z of dK
// and dV. S and dP still take the whole head_dim: for each query tile the
// block streams K, V, Q and dO through their tiles chunk by chunk, its own
// chunk last, so that Qs and dOs hold the chunks the dK and dV products read.
template <typename T, int D, typename Mask, bool SPLIT = false>
// Shared memory allows two blocks per SM at head_dim <= 64 (one at 128 and
// 256): saying so keeps ptxas from squeezing the kernel into 64 registers
// with spills to reach an occupancy the shared memory rules out.
__global__ void __launch_bounds__(NT, D > 128 ? 1 : 2)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     Layout lay, Mask heads_mask, float scale) {
  constexpr int LD = D + 1;
  constexpr int DJ = D / 16;
  constexpr int KI = DkvFma<D>::KI, KR = DkvFma<D>::KR, LDS = DkvFma<D>::LDS;
  extern __shared__ float smem[];
  float* Ks = smem;            // [KR][LD]
  float* Vs = Ks + KR * LD;    // [KR][LD]
  float* Qs = Vs + KR * LD;    // [BQ][LD]
  float* dOs = Qs + BQ * LD;   // [BQ][LD]
  float* Ps = dOs + BQ * LD;   // [BQ][LDS]
  float* dSs = Ps + BQ * LDS;  // [BQ][LDS]
  float* Ls = dSs + BQ * LDS;  // [BQ]
  float* Dl = Ls + BQ;         // [BQ]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int h = blockIdx.y;
  const Mask mask = heads_mask.at_head(h);
  const int kt = blockIdx.x;
  const int cz = SPLIT ? blockIdx.z : 0;  // the output chunk
  const int nch = SPLIT ? gridDim.z : 1;
  const T* qb = q + h * lay.q_hs;
  const T* dob = dout + h * lay.q_hs;
  const T* kb = k + h * lay.k_hs;
  const T* vb = v + h * lay.k_hs;
  const float* lb = lse + (size_t)h * lay.sq;
  const float* db = delta + (size_t)h * lay.sq;
  const int2 tiles = mask.query_tiles(kt);

  for (int k0 = kt * BK; k0 < min(kt * BK + BK, lay.sk); k0 += KR) {
    if (!SPLIT) {
      __syncthreads();  // the last pass's reads of Ks and Vs are done
      load_tile<T, KR, D>(Ks, kb, k0, lay.sk, lay.k_rs);
      load_tile<T, KR, D>(Vs, vb, k0, lay.sk, lay.k_rs);
    }

    float dk_acc[KI][DJ], dv_acc[KI][DJ];
    RowInfo ki[KI];  // the keys tx + 16 b of every score tile
#pragma unroll
    for (int b = 0; b < KI; ++b) ki[b] = mask.k_row(k0 + tx + 16 * b);
#pragma unroll
    for (int i = 0; i < KI; ++i)
#pragma unroll
      for (int c = 0; c < DJ; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

    for (int it = tiles.x; it < tiles.y; ++it) {
      if (!mask.tile_open(it, kt)) continue;  // the same for the whole block
      const int q0 = it * BQ;
      RowInfo qi[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qi[i] = mask.q_row(q0 + ty + 16 * i);
      // s = Q K^T and dP = dO V^T; thread holds query rows ty + 16 i, keys tx + 16 b
      float s[4][KI], dp[4][KI];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int b = 0; b < KI; ++b) s[i][b] = dp[i][b] = 0.f;
      // one pass over the head_dim unless SPLIT: then chunk cc, this block's last
      for (int n = 1; n <= nch; ++n) {
        const int cc = SPLIT ? (cz + n) % nch : 0;
        __syncthreads();  // the last reads of Ks, Vs, Qs, dOs, Ps and dSs are done
        if (SPLIT) {
          load_tile<T, KR, D>(Ks, kb + cc * D, k0, lay.sk, lay.k_rs);
          load_tile<T, KR, D>(Vs, vb + cc * D, k0, lay.sk, lay.k_rs);
        }
        load_tile<T, BQ, D>(Qs, qb + cc * D, q0, lay.sq, lay.q_rs);
        load_tile<T, BQ, D>(dOs, dob + cc * D, q0, lay.sq, lay.q_rs);
        if (n == 1) {
          load_rowvec(Ls, lb, q0, lay.sq, BQ);
          load_rowvec(Dl, db, q0, lay.sq, BQ);
        }
        __syncthreads();
#pragma unroll 4
        for (int d = 0; d < D; ++d) {
          float qa[4], oa[4], kv[KI], vv[KI];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            qa[i] = Qs[(ty + 16 * i) * LD + d];
            oa[i] = dOs[(ty + 16 * i) * LD + d];
          }
#pragma unroll
          for (int b = 0; b < KI; ++b) {
            kv[b] = Ks[(tx + 16 * b) * LD + d];
            vv[b] = Vs[(tx + 16 * b) * LD + d];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int b = 0; b < KI; ++b) {
              s[i][b] = fmaf(qa[i], kv[b], s[i][b]);
              dp[i][b] = fmaf(oa[i], vv[b], dp[i][b]);
            }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int b = 0; b < KI; ++b) {
          const int col = tx + 16 * b;
          const bool ok = mask.visible(qi[i], ki[b]);
          const float p = ok ? expf(s[i][b] * scale - Ls[r]) : 0.f;
          Ps[r * LDS + col] = p;
          dSs[r * LDS + col] = p * (dp[i][b] - Dl[r]) * scale;
        }
      }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q; thread holds key rows ty + 16 i, dims tx + 16 c
#pragma unroll 4
      for (int qq = 0; qq < BQ; ++qq) {
        float pa[KI], sa[KI], ob[DJ], qv[DJ];
#pragma unroll
        for (int i = 0; i < KI; ++i) {
          pa[i] = Ps[qq * LDS + ty + 16 * i];
          sa[i] = dSs[qq * LDS + ty + 16 * i];
        }
#pragma unroll
        for (int c = 0; c < DJ; ++c) {
          ob[c] = dOs[qq * LD + tx + 16 * c];
          qv[c] = Qs[qq * LD + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < KI; ++i)
#pragma unroll
          for (int c = 0; c < DJ; ++c) {
            dv_acc[i][c] = fmaf(pa[i], ob[c], dv_acc[i][c]);
            dk_acc[i][c] = fmaf(sa[i], qv[c], dk_acc[i][c]);
          }
      }
    }

#pragma unroll
    for (int i = 0; i < KI; ++i) {
      const int kp = k0 + ty + 16 * i;
      if (kp >= lay.sk) continue;
      T* dkrow = dk + h * lay.k_hs + kp * lay.k_rs + cz * D;
      T* dvrow = dv + h * lay.k_hs + kp * lay.k_rs + cz * D;
#pragma unroll
      for (int c = 0; c < DJ; ++c) {
        dkrow[tx + 16 * c] = from_f<T>(dk_acc[i][c]);
        dvrow[tx + 16 * c] = from_f<T>(dv_acc[i][c]);
      }
    }
  }
}

// ------------------------------------------------ the bf16 tensor-core kernel

// The bf16 kernel's shared memory: the K and V tiles, then STAGES (Q, dO)
// stages, then each stage's lse and delta rows (2 x 64 floats), then the
// mbarriers (1024 bytes of slack to align the tiles).
template <int D>
struct DkvRing {
  static constexpr int STAGES = D == 128 ? 2 : 3;
  static constexpr size_t SMEM = 1024 + (size_t)HopTile<D>::BYTES * (2 + 2 * STAGES) +
                                 sizeof(float) * 2 * BQ * STAGES +
                                 sizeof(uint64_t) * (1 + STAGES);
};

// One query tile's P^T and dS^T on the S^T accumulator `st` (key rows r
// and r + 8: h2 = 0, 1; query columns 8 jj + cq + e) and dP^T in `dpt`:
// p = exp(s scale - lse) under the mask, left in `st`, and
// dS = p (dP - delta) scale, left in `dpt`. `stats` holds the query tile's
// lse * log2(e), then its delta. FULL: the mask keeps every pair of the
// tile, so no element is tested.
template <bool FULL, typename Mask>
__device__ __forceinline__ void dkv_p_ds_tile(const Mask& mask, int i, const RowInfo (&ki)[2],
                                              int cq, float scale, const float* stats,
                                              float (&st)[32], float (&dpt)[32]) {
  const float scale_log2 = scale * LOG2E;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * jj + cq + e;
      const float lse2 = stats[col], dl = stats[BQ + col];
      RowInfo qi{};
      if (!FULL) qi = mask.q_row(i * BQ + col);
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int x = 4 * jj + 2 * h2 + e;
        float p = exp2_ftz(fmaf(st[x], scale_log2, -lse2));
        if (!FULL && !mask.visible(qi, ki[h2])) p = 0.f;
        st[x] = p;
        dpt[x] = p * (dpt[x] - dl) * scale;
      }
    }
}

template <int D, typename Mask>
__global__ void __launch_bounds__(HOP_CONSUMERS, D == 128 ? 1 : 2)
flash_bwd_dkv_hopper(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                     const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, Layout lay, Mask heads_mask, float scale,
                     int packed, int tiles_x) {
  using Tile = HopTile<D>;
  constexpr int STAGES = DkvRing<D>::STAGES;
  using namespace pt_hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Ks = align_1024(smem_raw);
  uint8_t* Vs = Ks + Tile::BYTES;
  uint8_t* QdOs = Vs + Tile::BYTES;  // stage s: Q at 2 s tiles on, dO one tile after
  // stage s: the query tile's 64 lse * log2(e), then its 64 delta
  float* stats = reinterpret_cast<float*>(QdOs + 2 * STAGES * Tile::BYTES);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(stats + 2 * BQ * STAGES);
  uint64_t* full = kv_full + 1;

  const int h = tiles_x ? blockIdx.y : blockIdx.x;
  const int kt = tiles_x ? blockIdx.x : blockIdx.y;
  const int k0 = kt * BK;
  const Mask mask = heads_mask.at_head(h);
  const int2 tiles = mask.query_tiles(kt);
  // the query tiles visited, in order: the loads and the products walk the
  // same list
  auto next_tile = [&](int i) {
    for (++i; i < tiles.y && !mask.tile_open(i, kt); ++i) {
    }
    return i;
  };
  const int t = threadIdx.x;
  const float* lb = lse + (size_t)h * lay.sq;
  const float* db = delta + (size_t)h * lay.sq;
  // thread t's value of query tile i's stats: lse * log2(e) of row t, or
  // delta of row t - 64; 0 past the last row
  auto stat = [&](int i) {
    const int qp = i * BQ + (t & (BQ - 1));
    if (qp >= lay.sq) return 0.f;
    return t < BQ ? lb[qp] * LOG2E : db[qp];
  };
  // query tile i into ring stage s: every thread stores its stats value and
  // arrives, thread 0 with the TMA loads' byte count
  auto load_stage = [&](int s, int i, float value) {
    stats[2 * BQ * s + t] = value;
    if (t == 0) {
      mbar_arrive_expect_tx(full + s, 2 * Tile::BYTES);
      uint8_t* Qs = QdOs + 2 * s * Tile::BYTES;
      tma_tile<D>(Qs, &tm_q, full + s, i * BQ, h, packed);
      tma_tile<D>(Qs + Tile::BYTES, &tm_do, full + s, i * BQ, h, packed);
    } else {
      mbar_arrive(full + s);
    }
  };

  if (t == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) mbar_init(full + s, HOP_CONSUMERS);
    mbar_fence_init();
    tma_prefetch_map(&tm_k);
    tma_prefetch_map(&tm_v);
    tma_prefetch_map(&tm_q);
    tma_prefetch_map(&tm_do);
  }
  __syncthreads();
  if (t == 0) {
    mbar_arrive_expect_tx(kv_full, 2 * Tile::BYTES);
    tma_tile<D>(Ks, &tm_k, kv_full, k0, h, packed);
    tma_tile<D>(Vs, &tm_v, kv_full, k0, h, packed);
  }
  int fill = next_tile(tiles.x - 1);  // the next query tile to load
  for (int s = 0; s < STAGES && fill < tiles.y; ++s, fill = next_tile(fill))
    load_stage(s, fill, stat(fill));

  // Thread t holds key rows r and r + 8 of the tile and, of each 8 columns
  // of S^T, dP^T, dK or dV, the pair at 2 * (t % 4).
  const int r = 16 * (t / 32) + (t % 32) / 4;
  const int cq = 2 * (t % 4);
  const uint32_t k_addr = smem_u32(Ks), v_addr = smem_u32(Vs);
  auto q_addr = [&](int s) { return smem_u32(QdOs + 2 * s * Tile::BYTES); };

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const RowInfo ki[2] = {mask.k_row(k0 + r), mask.k_row(k0 + r + 8)};

  mbar_wait(kv_full, 0);
  int it = 0;
  for (int i = next_tile(tiles.x - 1); i < tiles.y; i = next_tile(i), ++it) {
    const int s = it % STAGES;
    // the stats of the tile that will refill this stage, read now so that
    // the load's latency passes under the products
    const float next_stat = fill < tiles.y ? stat(fill) : 0.f;
    // S^T and dP^T are this tile's alone: set here, so that no value of
    // them stays live across the loop (the products' operands read them)
    float st[32], dpt[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) st[x] = dpt[x] = 0.f;
    mbar_wait(full + s, (it / STAGES) & 1);
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
    wgmma_nt<D>(st, k_addr, q_addr(s));                  // S^T = K Q^T
    wgmma_nt<D>(dpt, v_addr, q_addr(s) + Tile::BYTES);   // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);
    const float* stats_s = stats + 2 * BQ * s;
    if (mask.tile_full(i, kt))
      dkv_p_ds_tile<true>(mask, i, ki, cq, scale, stats_s, st, dpt);
    else
      dkv_p_ds_tile<false>(mask, i, ki, cq, scale, stats_s, st, dpt);
    // P^T and dS^T as A operands, hi and lo parts: their k-th 16 queries
    // are values 8k .. 8k + 7
    uint32_t ph[4][4], pl[4][4], sh[4][4], sl[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        pack_bf16_split(st[8 * k + 2 * x], st[8 * k + 2 * x + 1], ph[k][x], pl[k][x]);
        pack_bf16_split(dpt[8 * k + 2 * x], dpt[8 * k + 2 * x + 1], sh[k][x], sl[k][x]);
      }
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // dV += P^T dO
      wgmma_rs_d<D>(dv_acc, ph[k], Tile::mn_major(q_addr(s) + Tile::BYTES, k));
      wgmma_rs_d<D>(dv_acc, pl[k], Tile::mn_major(q_addr(s) + Tile::BYTES, k));
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // dK += dS^T Q
      wgmma_rs_d<D>(dk_acc, sh[k], Tile::mn_major(q_addr(s), k));
      wgmma_rs_d<D>(dk_acc, sl[k], Tile::mn_major(q_addr(s), k));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      fence_regs(ph[k]);
      fence_regs(pl[k]);
      fence_regs(sh[k]);
      fence_regs(sl[k]);
    }
    if (fill < tiles.y) {  // the same for the whole block
      __syncthreads();       // every thread's products and stats reads are done
      load_stage(s, fill, next_stat);
      fill = next_tile(fill);
    }
  }

#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int kp = k0 + r + 8 * h2;
    if (kp >= lay.sk) continue;
    const long long off = h * lay.k_hs + (long long)kp * lay.k_rs + cq;
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd) {
      const int x = 4 * jd + 2 * h2;
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * jd) =
          __floats2bfloat162_rn(dk_acc[x], dk_acc[x + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * jd) =
          __floats2bfloat162_rn(dv_acc[x], dv_acc[x + 1]);
    }
  }
}

template <int D, typename Mask>
cudaError_t dkv_hopper(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int heads,
                       Layout lay, Mask mask, float scale, int packed, void* stream) {
  const int nkt = (lay.sk + BK - 1) / BK;
  // as the forward's grid (fwd_hopper): one head's tiles side by side for
  // the fixed-length mask, the heads side by side for the others
  const int tiles_x = std::is_same<Mask, CausalMask>::value;
  const dim3 grid = tiles_x ? dim3(nkt, heads) : dim3(heads, nkt);
  if (grid.y > 65535 || heads < 1 || nkt < 1) return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mdo;
  int err = hop_map<D>(&mq, q, lay.sq, heads, lay.q_rs, lay.q_hs, packed);
  if (!err) err = hop_map<D>(&mdo, dout, lay.sq, heads, lay.q_rs, lay.q_hs, packed);
  if (!err) err = hop_map<D>(&mk, k, lay.sk, heads, lay.k_rs, lay.k_hs, packed);
  if (!err) err = hop_map<D>(&mv, v, lay.sk, heads, lay.k_rs, lay.k_hs, packed);
  if (err) return (cudaError_t)err;
  return launch_nt(flash_bwd_dkv_hopper<D, Mask>, grid, HOP_CONSUMERS, DkvRing<D>::SMEM, stream,
                   mq,
                   mk, mv, mdo, (const float*)lse, (const float*)delta, (__nv_bfloat16*)dk,
                   (__nv_bfloat16*)dv, lay, mask, scale, packed, tiles_x);
}

// ------------------------------------------------------ launch and entries

// `chunks` > 1: the SPLIT kernel, one block per 256-column chunk of dK, dV.
template <typename T, int D, typename Mask, bool SPLIT = false>
cudaError_t dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                const void* delta, void* dk, void* dv, int heads, Layout lay, Mask mask,
                float scale, void* stream, int chunks = 1) {
  const dim3 grid((lay.sk + BK - 1) / BK, heads, chunks);
  return launch(flash_bwd_dkv_kernel<T, D, Mask, SPLIT>, grid, DkvFma<D>::SMEM, stream,
                (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
                (const float*)delta, (T*)dk, (T*)dv, lay, mask, scale);
}

// bf16 to the tensor-core kernel, float and fp16 to the FMA kernel (io:
// see Io); head_dim 256 to the FMA kernel at every io type, and a head_dim
// above 256 (a multiple of 256: the wrappers pad to it) to the FMA kernel
// split over it. `packed` says the tensors are [T, H, D] (varlen) rather
// than [BH, S, D]. One slice of at most MAX_GRID_Y heads.
template <typename Mask>
cudaError_t dkv_heads(int d, int io, const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta, void* dk, void* dv,
                      int heads, Layout lay, Mask mask, float scale, int packed, void* stream) {
  if (d > 256) {
    if (d % 256) return cudaErrorInvalidValue;
    PT_FLASH_SWITCH_IO(io, return dkv<T, 256, Mask, true>(q, k, v, dout, lse, delta, dk, dv,
                                                          heads, lay, mask, scale, stream,
                                                          d / 256))
  }
  if (d == 256) {
    PT_FLASH_SWITCH_IO(io, return dkv<T, 256>(q, k, v, dout, lse, delta, dk, dv, heads, lay,
                                              mask, scale, stream))
  }
  if (io == IO_BF16) {
    PT_FLASH_SWITCH_D(d, return dkv_hopper<D>(q, k, v, dout, lse, delta, dk, dv, heads, lay, mask,
                                              scale, packed, stream))
  }
  PT_FLASH_SWITCH_D(d, PT_FLASH_SWITCH_FMA_IO(io, return dkv<T, D>(q, k, v, dout, lse, delta, dk,
                                                                   dv, heads, lay, mask, scale,
                                                                   stream)))
}

// dkv_heads over every slice of the heads (by_head_slices).
template <typename Mask>
cudaError_t dkv_any(int d, int io, const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta, void* dk, void* dv,
                    int heads, Layout lay, Mask mask, float scale, int packed, void* stream) {
  const long long e = io_bytes(io);
  return by_head_slices(heads, [&](int h0, int n) {
    const long long rows = (long long)h0 * lay.sq;
    return dkv_heads(d, io, at(q, h0 * lay.q_hs, e), at(k, h0 * lay.k_hs, e),
                     at(v, h0 * lay.k_hs, e), at(dout, h0 * lay.q_hs, e), at(lse, rows, 4),
                     at(delta, rows, 4), at(dk, h0 * lay.k_hs, e), at(dv, h0 * lay.k_hs, e), n,
                     lay, mask.from_head(h0), scale, packed, stream);
  });
}

}  // namespace pt_flash

// Every entry: io 0 float, 1 bf16, 2 fp16 (pt_flash::Io); bf16 q, k, v and
// dout start on 16-byte boundaries (their tensor maps need it; the
// wrappers see to it); a failed tensor-map encode returns the error code
// of libcuda, a refused launch cudaGetLastError().
//
// q, dout [bh, sq, d] and k, v, dk, dv [bh, sk, d] in the io type,
// contiguous; lse and delta float [bh, sq]. Launches on `stream` and
// returns cudaGetLastError().
extern "C" int pt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dk, void* dv, int bh,
                                int sq, int sk, int d, int io, int causal, float scale,
                                int kv_len, int q_offset, void* stream) {
  const pt_flash::CausalMask mask{sq, causal, kv_len, q_offset};
  return (int)pt_flash::dkv_any(d, io, q, k, v, dout, lse, delta, dk, dv, bh,
                                pt_flash::dense_layout(sq, sk, d), mask, scale, 0, stream);
}

// q, dout [tq, h, d] and k, v, dk, dv [tk, h, d] in the io type, contiguous;
// lse and delta float [h, tq]; seg/pos as for pt_varlen_fwd; lo/hi int32
// [ceil(tk / 64)]: the query tiles each key tile visits. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int pt_varlen_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dk, void* dv,
                                 const int* seg_q, const int* pos_q, const int* seg_k,
                                 const int* pos_k, const int* lo, const int* hi, int h, int tq,
                                 int tk, int d, int io, int causal, float scale,
                                 void* stream) {
  const pt_flash::SegmentMask mask{seg_q, pos_q, seg_k, pos_k, lo, hi, causal};
  return (int)pt_flash::dkv_any(d, io, q, k, v, dout, lse, delta, dk, dv, h,
                                pt_flash::packed_layout(tq, tk, h, d), mask, scale, 1, stream);
}

// q, dout [bh, sq, d] and k, v, dk, dv [bh, sk, d] in the io type,
// contiguous; lse and delta float [bh, sq]; st/en/st_max/en_min as for
// pt_flashmask_fwd. Launches on `stream` and returns cudaGetLastError().
extern "C" int pt_flashmask_bwd_dkv(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dk, void* dv, const int* st, const int* en,
                                    const int* st_max, const int* en_min, int bh, int h, int hs,
                                    int sq, int sk, int d, int io, int causal, float scale,
                                    void* stream) {
  const pt_flash::StartEndMask mask{st, en, st_max, en_min, h, hs, sq, sk, causal};
  return (int)pt_flash::dkv_any(d, io, q, k, v, dout, lse, delta, dk, dv, bh,
                                pt_flash::dense_layout(sq, sk, d), mask, scale, 0, stream);
}
