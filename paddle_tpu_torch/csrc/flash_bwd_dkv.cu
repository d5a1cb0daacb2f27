// Flash-attention backward, dK and dV, for Hopper (sm_90a): fixed-length
// causal batches, packed variable-length sequences and flashmask (start/end
// row) masks, two kernels templated on the mask: a tensor-core kernel for
// bf16 and fp16 io (`flash_bwd_dkv_hopper`, templated on the 2-byte io type
// too) and an fp32 FMA kernel for float io (`flash_bwd_dkv_kernel`).
// `dkv_any` picks one by the io type. The tensor-core kernel has two forms: head_dim 32, 64 and 128 (one warpgroup) and
// head_dim 256 (two warpgroups, `dkv_wide`); a head_dim above 256 (a
// multiple of 256: the wrappers pad to it) runs either kernel's 256 form
// split over it (SPLIT): one block per 256-column chunk of dK and dV, S and
// dP over the whole head_dim recomputed by every chunk's block.
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
// The tensor-core kernel (`flash_bwd_dkv_hopper`), one block per (head,
// 64-row key tile), one warpgroup (128 threads).
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
//   P and dS are each split into two parts of the io type, hi = T(x) and
//   lo = T(x - hi), each a product into the same fp32 accumulator:
//   rounding them once to bf16 would leave each term off by up to 2^-9 of
//   itself, which summed over a thousand queries is several times the card
//   tests' limit on elements near 0; hi + lo keeps about 2^-17. So the
//   kernel runs 6 products a tile where the TPU's runs 4, and holds the
//   reference's fp32 P and dS.
// - fp16 io: the same design and products (f16 operands, same rate). One
//   fp16 rounding misses the fp16 limit (8x tighter) as bf16's misses its
//   own, so the split stays; but fp16's range is small: below 2^-14 it is
//   subnormal, and hi + lo then keeps only an absolute 2^-25. So P is split
//   at 2^14 times itself (folded into the stats' lse, P_EXP; p <= 1, so no
//   overflow), and each key row of dS at a power of two of its own that
//   puts the row's largest |dS| in [2^14, 2^15) (`ds_rows`: dS follows dO's
//   scale, 2^-12 and 2^8 of unit scale alike under a loss scaler); the
//   epilogue divides both out, exactly.
// - Registers: S^T and dP^T (32 each), dK and dV (D / 2 each) and the
//   A operands (16 for each of P hi, P lo, dS hi, dS lo) a thread; D <= 64
//   runs two blocks an SM (up to 255 registers a thread), D = 128 one.
// The FMA kernel (`flash_bwd_dkv_kernel`), 256 threads: products as fp32
// FMAs from shared memory, for the fp32 models and checks, at
// head_dim 256 in two 32-key passes (DkvFma) and, split over the head_dim
// in 256-column chunks of dK and dV (SPLIT), above it.
//
// The tensor-core kernel at head_dim 256 (`dkv_wide`), one block per (head,
// 64-row key tile, 256-column chunk of dK and dV), 256 threads: two
// consumer warpgroups on the same key tile. What bounds it at the
// fixed-length shape (BH = 128, S = 1024, D = 256, causal): 1.4e11 FLOP
// (139 us) against 404 MB (121 us): the operations.
// - Registers decide the split. dK and dV are 128 fp32 a thread each at
//   D = 256, so one warpgroup cannot hold both: warpgroup 0 computes
//   S^T = K Q^T, P^T and dV += P^T dO (hi, lo); warpgroup 1 computes S^T,
//   dP^T = V dO^T, dS^T and dK += dS^T Q (hi, lo). S^T is computed twice:
//   7 products a query tile where 6 would do, but each thread holds one
//   accumulator (128), S^T and dP^T (64) and then 32 of packed A operand.
//   The alternatives cost more products: each warpgroup owning 128 columns
//   of both dK and dV recomputes S^T and dP^T in both (8), and a grid
//   split of the columns recomputes them per block. ptxas gives 229-254
//   registers, no spill, one block an SM; the query tile's lse and delta
//   go through 1 KB of shared memory (each warpgroup stores them between
//   two of its own barriers), not 16 registers a thread.
// - Shared memory, the forward's seven 32 KB buffers (WideSmem): K's and
//   V's chunks resident up to D = 512 (two buffers a chunk), the rest a
//   ring of (Q, dO) tiles (5 slots at D = 256, 3 at 512); above 512 all
//   seven are the ring and K and V stream beside Q and dO. Per query tile
//   the fills are, chunk by chunk with the block's own chunk last,
//   [K_c, V_c,] Q_c, dO_c; Q and dO of the own chunk stay until the dK and
//   dV products are done. Thread 0 (the dV warpgroup, which has the fewer
//   products) issues them, as in the dQ kernel.
// - Products a query tile: S^T (and dP^T) as 16 `wgmma` m64n64k16 per
//   chunk, then 4 m64n256k16 for hi and 4 for lo, dO or Q MN-major.
//
// Grid: FMA (ceil(Sk / 64), heads, head_dim / 256 above 256); tensor cores
// below 256 the same for the fixed-length mask and (heads, ceil(Sk / 64))
// for the varlen and flashmask masks, the key tiles first to last (the
// longest first under a causal mask); tensor cores at 256 and above
// (ceil(Sk / 64) * chunks, heads) or (heads, ceil(Sk / 64) * chunks), the
// chunk varying fastest; at most 65535 heads a launch (by_head_slices).
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
template <int D, typename Mask, bool SPLIT = false>
// Shared memory allows two blocks per SM at head_dim <= 64 (one at 128 and
// 256): saying so keeps ptxas from squeezing the kernel into 64 registers
// with spills to reach an occupancy the shared memory rules out.
__global__ void __launch_bounds__(NT, D > 128 ? 1 : 2)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, Layout lay, Mask heads_mask,
                     float scale) {
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
  const float* qb = q + h * lay.q_hs;
  const float* dob = dout + h * lay.q_hs;
  const float* kb = k + h * lay.k_hs;
  const float* vb = v + h * lay.k_hs;
  const float* lb = lse + (size_t)h * lay.sq;
  const float* db = delta + (size_t)h * lay.sq;
  const int2 tiles = mask.query_tiles(kt);

  for (int k0 = kt * BK; k0 < min(kt * BK + BK, lay.sk); k0 += KR) {
    if (!SPLIT) {
      __syncthreads();  // the last pass's reads of Ks and Vs are done
      load_tile<KR, D>(Ks, kb, k0, lay.sk, lay.k_rs);
      load_tile<KR, D>(Vs, vb, k0, lay.sk, lay.k_rs);
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
          load_tile<KR, D>(Ks, kb + cc * D, k0, lay.sk, lay.k_rs);
          load_tile<KR, D>(Vs, vb + cc * D, k0, lay.sk, lay.k_rs);
        }
        load_tile<BQ, D>(Qs, qb + cc * D, q0, lay.sq, lay.q_rs);
        load_tile<BQ, D>(dOs, dob + cc * D, q0, lay.sq, lay.q_rs);
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
      float* dkrow = dk + h * lay.k_hs + kp * lay.k_rs + cz * D;
      float* dvrow = dv + h * lay.k_hs + kp * lay.k_rs + cz * D;
#pragma unroll
      for (int c = 0; c < DJ; ++c) {
        dkrow[tx + 16 * c] = dk_acc[i][c];
        dvrow[tx + 16 * c] = dv_acc[i][c];
      }
    }
  }
}

// ------------------------------------------ the bf16 and fp16 tensor-core kernel

// The tensor-core kernel's shared memory: the K and V tiles, then STAGES (Q, dO)
// stages, then each stage's lse and delta rows (2 x 64 floats), then the
// mbarriers (1024 bytes of slack to align the tiles).
template <int D>
struct DkvRing {
  static constexpr int STAGES = D == 128 ? 2 : 3;
  static constexpr size_t SMEM = 1024 + (size_t)HopTile<D>::BYTES * (2 + 2 * STAGES) +
                                 sizeof(float) * 2 * BQ * STAGES +
                                 sizeof(uint64_t) * (1 + STAGES);
};

// fp16 io: P is split at 2^P_EXP times itself (P_EXP is subtracted from
// the stats' lse * log2(e)); bf16 at itself.
template <typename T>
constexpr float P_EXP = pt_hopper::is_f16<T> ? 14.f : 0.f;
template <typename T>
constexpr float P_MUL = pt_hopper::is_f16<T> ? 16384.f : 1.f;

// One query tile's P^T and dS^T on the S^T accumulator `st` (key rows r
// and r + 8: h2 = 0, 1; query columns 8 jj + cq + e) and dP^T in `dpt`:
// p = exp(s scale - lse) under the mask, left in `st`, and
// dS = p (dP - delta) ds_scale, left in `dpt` (ds_scale: the scale over
// P_MUL, so that dS comes out unscaled). `stats` holds the query tile's
// lse * log2(e) - P_EXP, then its delta. FULL: the mask keeps every pair of
// the tile, so no element is tested.
template <bool FULL, typename Mask>
__device__ __forceinline__ void dkv_p_ds_tile(const Mask& mask, int i, const RowInfo (&ki)[2],
                                              int cq, float scale, float ds_scale,
                                              const float* stats, float (&st)[32],
                                              float (&dpt)[32]) {
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
        dpt[x] = p * (dpt[x] - dl) * ds_scale;
      }
    }
}

// The one-warpgroup form (head_dim 32, 64, 128), io type T.
template <int D, typename T, typename Mask>
__device__ __forceinline__ void dkv_narrow(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                                           const CUtensorMap& tm_v, const CUtensorMap& tm_do,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ delta,
                                           T* __restrict__ dk, T* __restrict__ dv,
                                           const Layout& lay, const Mask& heads_mask, float scale,
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
  // thread t's value of query tile i's stats: lse * log2(e) - P_EXP of
  // row t, or delta of row t - 64; 0 past the last row
  auto stat = [&](int i) {
    const int qp = i * BQ + (t & (BQ - 1));
    if (qp >= lay.sq) return 0.f;
    return t < BQ ? lb[qp] * LOG2E - P_EXP<T> : db[qp];
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
  float ds_mul[2] = {DS_MUL_MAX, DS_MUL_MAX};  // fp16: ds_rows' powers

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
    wgmma_nt<D, T>(st, k_addr, q_addr(s));                 // S^T = K Q^T
    wgmma_nt<D, T>(dpt, v_addr, q_addr(s) + Tile::BYTES);  // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);
    const float* stats_s = stats + 2 * BQ * s;
    const float ds_scale = scale / P_MUL<T>;
    if (mask.tile_full(i, kt))
      dkv_p_ds_tile<true>(mask, i, ki, cq, scale, ds_scale, stats_s, st, dpt);
    else
      dkv_p_ds_tile<false>(mask, i, ki, cq, scale, ds_scale, stats_s, st, dpt);
    if constexpr (pt_hopper::is_f16<T>) ds_rows(dpt, ds_mul, dk_acc);
    // P^T and dS^T as A operands, hi and lo parts: their k-th 16 queries
    // are values 8k .. 8k + 7
    uint32_t ph[4][4], pl[4][4], sh[4][4], sl[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        pack_split<T>(st[8 * k + 2 * x], st[8 * k + 2 * x + 1], ph[k][x], pl[k][x]);
        pack_split<T>(dpt[8 * k + 2 * x], dpt[8 * k + 2 * x + 1], sh[k][x], sl[k][x]);
      }
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // dV += P^T dO
      wgmma_rs_d<D, T>(dv_acc, ph[k], Tile::mn_major(q_addr(s) + Tile::BYTES, k));
      wgmma_rs_d<D, T>(dv_acc, pl[k], Tile::mn_major(q_addr(s) + Tile::BYTES, k));
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // dK += dS^T Q
      wgmma_rs_d<D, T>(dk_acc, sh[k], Tile::mn_major(q_addr(s), k));
      wgmma_rs_d<D, T>(dk_acc, sl[k], Tile::mn_major(q_addr(s), k));
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
    // fp16: the powers the products were scaled by, divided out
    float dk_mul = 1.f, dv_mul = 1.f;
    if constexpr (pt_hopper::is_f16<T>) {
      dk_mul = 1.f / ds_mul[h2];
      dv_mul = 1.f / P_MUL<T>;
    }
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd) {
      const int x = 4 * jd + 2 * h2;
      *reinterpret_cast<uint32_t*>(dk + off + 8 * jd) =
          pack2<T>(dk_acc[x] * dk_mul, dk_acc[x + 1] * dk_mul);
      *reinterpret_cast<uint32_t*>(dv + off + 8 * jd) =
          pack2<T>(dv_acc[x] * dv_mul, dv_acc[x + 1] * dv_mul);
    }
  }
}

// dkv_p_ds_tile's P^T alone (the dV warpgroup of the head_dim-256 form),
// left in `st`.
template <bool FULL, typename Mask>
__device__ __forceinline__ void dkv_p_tile(const Mask& mask, int i, const RowInfo (&ki)[2],
                                           int cq, float scale, const float* stats,
                                           float (&st)[32]) {
  const float scale_log2 = scale * LOG2E;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * jj + cq + e;
      const float lse2 = stats[col];
      RowInfo qi{};
      if (!FULL) qi = mask.q_row(i * BQ + col);
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int x = 4 * jj + 2 * h2 + e;
        const float p = exp2_ftz(fmaf(st[x], scale_log2, -lse2));
        st[x] = FULL || mask.visible(qi, ki[h2]) ? p : 0.f;
      }
    }
}

// The head_dim-256 form: one 64-row key tile kt of head h and the
// 256-column chunk cz of dK and dV of `chunks` (SPLIT; 1 otherwise), io
// type T; warpgroup 0 computes dV, warpgroup 1 dK. See the notes at the top
// of the file.
template <typename T, typename Mask, bool SPLIT>
__device__ __forceinline__ void dkv_wide(const CUtensorMap* tm_q, const CUtensorMap* tm_k,
                                         const CUtensorMap* tm_v, const CUtensorMap* tm_do,
                                         const float* __restrict__ lse,
                                         const float* __restrict__ delta, T* __restrict__ dk,
                                         T* __restrict__ dv, const Layout& lay,
                                         const Mask& heads_mask, float scale, int packed,
                                         int tiles_x, int chunks) {
  using Tile = HopTile<256>;
  using namespace pt_hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* bufs = align_1024(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(bufs + WideSmem::BARRIERS);

  const int n = SPLIT ? chunks : 1;
  const bool kv_res = n <= 2;  // K's and V's chunks resident; else streamed
  const int kv_bufs = kv_res ? 2 * n : 0;
  const int per_chunk = kv_res ? 2 : 4;  // fills of a chunk: [K_c, V_c,] Q_c, dO_c

  // the grid's tile axis holds (key tile, chunk), the chunk fastest; key
  // tiles first to last, the longest first under a causal mask
  const int h = tiles_x ? blockIdx.y : blockIdx.x;
  const int tile = tiles_x ? blockIdx.x : blockIdx.y;
  const int cz = SPLIT ? tile % n : 0;
  const int kt = tile / n;
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

  // The fills, per query tile of the list and per chunk, this block's own
  // chunk last (its Q and dO stay for the dK and dV products): [K_c, V_c,]
  // Q_c, dO_c.
  auto more = [&](const RingIssuer& is) { return is.tile < tiles.y; };
  auto load = [&](RingIssuer& is, uint8_t* dst, uint64_t* bar) {
    const int c = (cz + 1 + is.fill / per_chunk) % n, sub = is.fill % per_chunk;
    const bool qo = sub + 2 >= per_chunk;
    const CUtensorMap* map = qo ? (sub + 2 == per_chunk ? tm_q : tm_do) : sub ? tm_v : tm_k;
    tma_tile<256>(dst, map, bar, qo ? is.tile * BQ : k0, h, packed, c * 256);
    if (++is.fill == per_chunk * n) {
      is.fill = 0;
      is.tile = next_tile(is.tile);
    }
  };
  auto ring = wide_ring(bufs, kv_bufs, next_tile(tiles.x - 1), more, load);
  if (threadIdx.x == 0) {
    tma_prefetch_map(tm_k);
    tma_prefetch_map(tm_v);
    tma_prefetch_map(tm_q);
    tma_prefetch_map(tm_do);
    if (kv_res) {  // buffers 2 c and 2 c + 1: K's and V's chunk c
      mbar_arrive_expect_tx(kv_full, kv_bufs * Tile::BYTES);
      for (int x = 0; x < kv_bufs; ++x)
        tma_tile<256>(bufs + x * Tile::BYTES, x & 1 ? tm_v : tm_k, kv_full, k0, h, packed,
                      (x >> 1) * 256);
    }
  }

  // A consumer warpgroup: w = 0 computes dV, w = 1 dK. Thread t holds key
  // rows r and r + 8 of the tile and, of each 8 columns of S^T, dP^T, dK or
  // dV, the pair at 2 * (t % 4).
  const int w = threadIdx.x / HOP_CONSUMERS;
  const int t = threadIdx.x % HOP_CONSUMERS;
  const int r = 16 * (t / 32) + (t % 32) / 4;
  const int cq = 2 * (t % 4);
  const float* lb = lse + (size_t)h * lay.sq;
  const float* db = delta + (size_t)h * lay.sq;
  // this warpgroup's query tile's 64 lse * log2(e), then its 64 delta
  float* stats = reinterpret_cast<float*>(bufs + WideSmem::STATS) + w * HOP_CONSUMERS;

  float acc[128];
#pragma unroll
  for (int x = 0; x < 128; ++x) acc[x] = 0.f;
  const RowInfo ki[2] = {mask.k_row(k0 + r), mask.k_row(k0 + r + 8)};
  float ds_mul[2] = {DS_MUL_MAX, DS_MUL_MAX};  // fp16, the dK warpgroup: ds_rows' powers

  if (kv_res) mbar_wait(kv_full, 0);
#pragma unroll 1
  for (int i = next_tile(tiles.x - 1); i < tiles.y; i = next_tile(i)) {
    // thread t's value of the tile's stats: lse * log2(e) - P_EXP of row t,
    // or delta of row t - 64; 0 past the last row (whose q and dO are 0, so
    // it adds exact zeros). Read now, stored after the products, so that
    // the load's latency passes under them.
    const int qp = i * BQ + (t & (BQ - 1));
    const float stat = qp >= lay.sq ? 0.f : t < BQ ? lb[qp] * LOG2E - P_EXP<T> : db[qp];
    // S^T and dP^T (the dK warpgroup's), fresh each tile
    float st[32], dpt[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) st[x] = dpt[x] = 0.f;
    int qs = 0, ds = 0;  // the slots of this block's chunk of Q and dO
#pragma unroll 1
    for (int ci = 0; ci < n; ++ci) {
      const int c = (cz + 1 + ci) % n;
      int ks = 0, vs = 0;
      if (!kv_res) {
        ks = ring.take();
        vs = ring.take();
      }
      qs = ring.take();
      ds = ring.take();
      uint32_t k_addr = kv_res ? smem_u32(bufs + 2 * c * Tile::BYTES) : ring.addr(ks);
      uint32_t v_addr = kv_res ? smem_u32(bufs + (2 * c + 1) * Tile::BYTES) : ring.addr(vs);
      asm volatile("" : "+r"(k_addr), "+r"(v_addr));
      if (w) {
        fence_regs(st);
        fence_regs(dpt);
        wgmma_fence();
        wgmma_nt<256, T>(st, k_addr, ring.addr(qs), ci > 0);   // S^T += K_c Q_c^T
        wgmma_nt<256, T>(dpt, v_addr, ring.addr(ds), ci > 0);  // dP^T += V_c dO_c^T
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);
      } else {
        fence_regs(st);
        wgmma_fence();
        wgmma_nt<256, T>(st, k_addr, ring.addr(qs), ci > 0);  // S^T += K_c Q_c^T
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
      }
      if (!kv_res) {
        ring.release(ks);
        ring.release(vs);
      }
      if (ci + 1 < n) {
        ring.release(qs);
        ring.release(ds);
      }
    }
    // the warpgroup's stats of this tile: every thread has read the last
    // tile's before the first barrier, and stored its value before the
    // second
    warpgroup_sync(w);
    stats[t] = stat;
    warpgroup_sync(w);
    // P^T (dV), or P^T and dS^T (dK): the dV warpgroup reads no dS^T
    const bool whole = mask.tile_full(i, kt);
    if (w) {
      const float ds_scale = scale / P_MUL<T>;
      if (whole)
        dkv_p_ds_tile<true>(mask, i, ki, cq, scale, ds_scale, stats, st, dpt);
      else
        dkv_p_ds_tile<false>(mask, i, ki, cq, scale, ds_scale, stats, st, dpt);
      if constexpr (pt_hopper::is_f16<T>) ds_rows(dpt, ds_mul, acc);
    } else {
      if (whole)
        dkv_p_tile<true>(mask, i, ki, cq, scale, stats, st);
      else
        dkv_p_tile<false>(mask, i, ki, cq, scale, stats, st);
    }
    // P^T (dV, in st) or dS^T (dK, in dpt) as the A operand, hi and lo
    // parts: its k-th 16 queries are values 8k .. 8k + 7; the B operand dO
    // or Q, MN-major
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int y = 8 * k + 2 * x;
        pack_split<T>(w ? dpt[y] : st[y], w ? dpt[y + 1] : st[y + 1], ah[k][x], al[k][x]);
      }
    const uint32_t b_addr = ring.addr(w ? qs : ds);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // dV += P^T dO_cz, dK += dS^T Q_cz
      wgmma_rs_d<256, T>(acc, ah[k], Tile::mn_major(b_addr, k));
      wgmma_rs_d<256, T>(acc, al[k], Tile::mn_major(b_addr, k));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      fence_regs(ah[k]);
      fence_regs(al[k]);
    }
    ring.release(qs);
    ring.release(ds);
  }
  // the fills the other warpgroup still takes
  if (threadIdx.x == 0) ring.issue(INT_MAX);

  T* out = w ? dk : dv;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int kp = k0 + r + 8 * h2;
    if (kp >= lay.sk) continue;
    T* row = out + h * lay.k_hs + (long long)kp * lay.k_rs + cz * 256 + cq;
    // fp16: the power the products were scaled by, divided out
    float mul = 1.f;
    if constexpr (pt_hopper::is_f16<T>) mul = w ? 1.f / ds_mul[h2] : 1.f / P_MUL<T>;
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
                                  D == 256 || D == 128 ? 1 : 2)
flash_bwd_dkv_hopper(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     Layout lay, Mask heads_mask, float scale, int packed, int tiles_x,
                     int chunks) {
  static_assert(D == 256 || !SPLIT, "SPLIT is the head_dim-256 form's");
  if constexpr (D == 256)
    dkv_wide<T, Mask, SPLIT>(&tm_q, &tm_k, &tm_v, &tm_do, lse, delta, dk, dv, lay, heads_mask,
                             scale, packed, tiles_x, chunks);
  else
    dkv_narrow<D, T, Mask>(tm_q, tm_k, tm_v, tm_do, lse, delta, dk, dv, lay, heads_mask, scale,
                           packed, tiles_x);
}

template <int D, typename T, typename Mask>
cudaError_t dkv_hopper(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int heads,
                       Layout lay, Mask mask, float scale, int packed, void* stream) {
  const int nkt = (lay.sk + BK - 1) / BK;
  // as the forward's grid (fwd_hopper): one head's tiles side by side for
  // the fixed-length mask, the heads side by side for the others
  // More than MAX_GRID_Y tiles go on x whatever the mask (x holds 2^31 - 1
  // blocks; by_head_slices keeps the heads on y within MAX_GRID_Y).
  const int tiles_x = std::is_same<Mask, CausalMask>::value || nkt > MAX_GRID_Y;
  const dim3 grid = tiles_x ? dim3(nkt, heads) : dim3(heads, nkt);
  if (heads < 1 || heads > MAX_GRID_Y || nkt < 1) return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mdo;
  int err = hop_map<D, T>(&mq, q, lay.sq, heads, lay.q_rs, lay.q_hs, packed);
  if (!err) err = hop_map<D, T>(&mdo, dout, lay.sq, heads, lay.q_rs, lay.q_hs, packed);
  if (!err) err = hop_map<D, T>(&mk, k, lay.sk, heads, lay.k_rs, lay.k_hs, packed);
  if (!err) err = hop_map<D, T>(&mv, v, lay.sk, heads, lay.k_rs, lay.k_hs, packed);
  if (err) return (cudaError_t)err;
  return launch_nt(flash_bwd_dkv_hopper<D, T, Mask>, grid, HOP_CONSUMERS, DkvRing<D>::SMEM,
                   stream, mq, mk, mv, mdo, (const float*)lse, (const float*)delta, (T*)dk,
                   (T*)dv, lay, mask, scale, packed, tiles_x, 1);
}

// The head_dim-256 form over `chunks` 256-column chunks of the head_dim
// (SPLIT when more than one).
template <typename T, typename Mask, bool SPLIT>
cudaError_t dkv_wide_launch(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dk, void* dv, int heads,
                            Layout lay, Mask mask, float scale, int packed, void* stream,
                            int chunks) {
  const long long nkt = (lay.sk + BK - 1) / BK;
  const long long ext = nkt * chunks;
  // as dkv_hopper: fixed-length tiles of one head side by side, the varlen
  // and flashmask heads side by side, more than MAX_GRID_Y on x
  const int tiles_x = std::is_same<Mask, CausalMask>::value || ext > MAX_GRID_Y;
  if (heads < 1 || heads > MAX_GRID_Y || nkt < 1 || ext > INT_MAX || (chunks > 1) != SPLIT)
    return cudaErrorInvalidValue;
  const dim3 grid = tiles_x ? dim3((unsigned)ext, heads) : dim3(heads, (unsigned)ext);
  const int d = 256 * chunks;
  CUtensorMap mq, mk, mv, mdo;
  int err = hop_map<256, T>(&mq, q, lay.sq, heads, lay.q_rs, lay.q_hs, packed, d);
  if (!err) err = hop_map<256, T>(&mdo, dout, lay.sq, heads, lay.q_rs, lay.q_hs, packed, d);
  if (!err) err = hop_map<256, T>(&mk, k, lay.sk, heads, lay.k_rs, lay.k_hs, packed, d);
  if (!err) err = hop_map<256, T>(&mv, v, lay.sk, heads, lay.k_rs, lay.k_hs, packed, d);
  if (err) return (cudaError_t)err;
  return launch_nt(flash_bwd_dkv_hopper<256, T, Mask, SPLIT>, grid, WIDE_NT, WideSmem::SMEM,
                   stream, mq, mk, mv, mdo, (const float*)lse, (const float*)delta, (T*)dk,
                   (T*)dv, lay, mask, scale, packed, tiles_x, chunks);
}

// ------------------------------------------------------ launch and entries

// The FMA kernel (float io); `chunks` > 1: the SPLIT kernel, one block per
// 256-column chunk of dK, dV.
template <int D, typename Mask, bool SPLIT = false>
cudaError_t dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                const void* delta, void* dk, void* dv, int heads, Layout lay, Mask mask,
                float scale, void* stream, int chunks = 1) {
  const dim3 grid((lay.sk + BK - 1) / BK, heads, chunks);
  return launch(flash_bwd_dkv_kernel<D, Mask, SPLIT>, grid, DkvFma<D>::SMEM, stream,
                (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
                (const float*)lse, (const float*)delta, (float*)dk, (float*)dv, lay, mask, scale);
}

// bf16 and fp16 to the tensor-core kernel, float to the FMA kernel (io:
// see Io), chosen by io type at every head_dim; head_dim 256 to either
// kernel's 256 form, and a head_dim above 256 (a multiple of 256: the
// wrappers pad to it) to the same form split over it. `packed` says the
// tensors are [T, H, D] (varlen) rather than [BH, S, D]. One slice of at
// most MAX_GRID_Y heads.
template <typename Mask>
cudaError_t dkv_heads(int d, int io, const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta, void* dk, void* dv,
                      int heads, Layout lay, Mask mask, float scale, int packed, void* stream) {
  if (d >= 256) {
    if (d % 256) return cudaErrorInvalidValue;
    const int chunks = d / 256;
    if (io == IO_F32)
      return chunks == 1 ? dkv<256>(q, k, v, dout, lse, delta, dk, dv, heads, lay, mask, scale,
                                    stream)
                         : dkv<256, Mask, true>(q, k, v, dout, lse, delta, dk, dv, heads, lay,
                                                mask, scale, stream, chunks);
    PT_FLASH_SWITCH_HOP_IO(
        io, return chunks == 1
                       ? dkv_wide_launch<T, Mask, false>(q, k, v, dout, lse, delta, dk, dv, heads,
                                                         lay, mask, scale, packed, stream, 1)
                       : dkv_wide_launch<T, Mask, true>(q, k, v, dout, lse, delta, dk, dv, heads,
                                                        lay, mask, scale, packed, stream, chunks))
  }
  if (io == IO_F32) {
    PT_FLASH_SWITCH_D(d, return dkv<D>(q, k, v, dout, lse, delta, dk, dv, heads, lay, mask,
                                       scale, stream))
  }
  PT_FLASH_SWITCH_D(d, PT_FLASH_SWITCH_HOP_IO(io, return dkv_hopper<D, T>(q, k, v, dout, lse,
                                                                          delta, dk, dv, heads,
                                                                          lay, mask, scale,
                                                                          packed, stream)))
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

// Every entry: io 0 float, 1 bf16, 2 fp16 (pt_flash::Io); bf16 and fp16 q,
// k, v and dout start on 16-byte boundaries (their tensor maps need it; the
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
