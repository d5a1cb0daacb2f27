// Flash-attention forward for Hopper (sm_90a): fixed-length causal batches,
// packed variable-length sequences and flashmask (start/end row) masks, two
// kernels templated on the mask: a tensor-core kernel for bf16 and fp16 io
// (`flash_fwd_hopper`, templated on the 2-byte io type too) and an fp32 FMA
// kernel for float io (`flash_fwd_kernel`). `fwd_any` sends bf16 and fp16
// to the first and float to the second, at every head_dim: the tensor cores
// have no fp32 product at fp32 accuracy (TF32 keeps 10 mantissa bits), so
// float io stays on FMAs. The tensor-core kernel has two forms: head_dim 32,
// 64 and 128 (one warpgroup, 64 query rows a block) and head_dim 256 (two
// warpgroups, 128 rows a block, `fwd_wide`). A head_dim above 256 (a
// multiple of 256: the wrappers pad to it) runs either kernel's 256 form
// split over it (SPLIT): one block per 256-column chunk of the output, the
// scores over the whole head_dim recomputed by every chunk's block.
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
// S = 1024, D = 64, bf16 or fp16, causal) 1.7e10 FLOP (17 us at 989 TFLOP/s)
// against 67 MB of q, k, v, o and lse (20 us at 3.35 TB/s): device memory.
// At the packed shape (T = 8192, H = 16, D = 64, bf16, ten causal
// documents, 5.8e6 kept pairs per head) 2.4e10 FLOP (24 us) against 68 MB
// (20 us): the operations, barely. At the flashmask shape (BH = 32,
// S = 4096, D = 64, bf16, causal, one batch row of share-question and one
// of document masks, 5.3e6 kept pairs per head) 2.2e10 FLOP (22 us) against
// 68 MB (20 us): the operations.
//
// The tensor-core kernel's one-warpgroup form (`fwd_narrow`, head_dim 32,
// 64 and 128), one block per (head, 64-row query tile), 160 threads: one consumer
// warpgroup and one producer warp.
// - The producer's first lane loads the Q tile with one TMA load (two at
//   D = 128) and streams K and V tiles through a ring of shared
//   memory stages, each signalled on a "full" mbarrier by the TMA's byte
//   count and handed back on an "empty" one by the 128 consumer threads.
//   TMA zero-fills rows past the tensor's end and swizzles the tiles the way
//   `wgmma` reads them (128 B rows, 64 B at D = 32). Producer and consumer
//   walk the same tile list: `key_tiles(qt)`, then `tile_open(qt, j)`.
// - S = Q K^T is D / 16 `wgmma` m64n64k16 from shared memory, both K-major;
//   O += P V is four m64nDk16 with P from registers (the S accumulator
//   rounded to the io type in place, in its fragment order) and V as the
//   MN-major B operand (the transpose bit). S of the next key tile and P V
//   of this one are in flight together, and the next tile's softmax runs
//   while the tensor cores do this tile's P V.
// - The softmax runs on the accumulator: a thread holds 2 rows x 16
//   columns of S, and the 4 threads of a quad share a row, so the row max
//   takes two xor shuffles; each thread keeps its part of the row sum until
//   the end. Tiles the mask keeps whole (`tile_full`) skip the mask.
// - Query tiles run last to first, so under a causal mask the longest start
//   first and the short early tiles fill the tail.
// The FMA kernel (`flash_fwd_kernel`), 256 threads: products as fp32 FMAs
// from shared memory (the same numbers the TPU kernel gets from
// fp32-accumulating MXU products); each thread holds a 4 x 4 block of
// scores and a 4 x D/16 block of the output and reads 8 shared words per
// 16 FMAs. It serves the fp32 models and checks.
//
// fp16 runs the bf16 design unchanged: `wgmma` takes f16 operands from the
// same descriptors at the same rate, TMA loads them with the same boxes and
// swizzle, and P is rounded to fp16 before P V as the TPU kernel rounds it
// to the io type (no scaling: p <= 1 and fp16 keeps 11 bits down to 2^-14).
//
// The tensor-core kernel at head_dim 256 (`fwd_wide`), one block per (head,
// 128-row query block, 256-column output chunk), 256 threads: two consumer
// warpgroups, one per 64-row query tile. What bounds it at the fixed-length
// shape (BH = 128, S = 1024, D = 256, causal): 6.9e10 FLOP (69 us) against
// 268 MB (80 us): device memory, barely; the design keeps the tensor cores
// fed rather than saving bytes.
// - Registers: a consumer thread holds 64 x 256 / 128 = 128 fp32 of O, 32
//   of S and 16 of P (about 210 in all), so one block a SM; no second S is
//   in flight inside a warpgroup. The two warpgroups take turns on the
//   tensor cores instead: one's softmax runs while the other's products
//   run. There is no producer warp: Hopper allocates registers a warpgroup
//   at a time, so one more warp would cost a third warpgroup's registers
//   (168 a thread, and the accumulators spill). Thread 0 issues the TMA
//   loads between its own products, in the order both warpgroups take
//   them, as far ahead as the ring has free slots.
// - Shared memory: seven 32 KB buffers of 64 rows x 256 columns (four
//   64-column boxes, 128 B swizzle). Q's chunks stay resident where they
//   fit (two tiles a chunk, the rest a ring: 5 ring slots at D = 256, 3 at
//   D = 512); above D = 512 all seven are the ring and Q's chunks stream
//   through it beside K's (L2 holds them). Per key tile the ring takes
//   [Q_c, Q_c',] K_c for each chunk c, then V's own chunk; each slot has a
//   "full" and an "empty" mbarrier (all 256 threads arrive).
// - The two query tiles visit different key tiles (a causal diagonal, a
//   document boundary, a banned flashmask tile): the ring holds every key
//   tile either visits, from the lower of their first tiles to the higher
//   of their ends, and a warpgroup that does not visit one still waits for
//   it and hands it back, so both walk the one list.
// - Products: S = Q K^T is 16 `wgmma` m64n64k16 from shared memory per
//   chunk; O += P V is 4 `wgmma` m64n256k16 with P from registers and V
//   MN-major. The softmax (`softmax_tile`) is the one-warpgroup kernel's.
//
// Grid: FMA (ceil(Sq / 64), heads, head_dim / 256 above 256); tensor cores
// below 256 the same for the fixed-length mask and (heads, ceil(Sq / 64))
// for the varlen and flashmask masks; tensor cores at 256 and above (ceil(Sq / 128) *
// chunks, heads) or (heads, ceil(Sq / 128) * chunks), the chunk varying
// fastest; at most 65535 heads a launch (by_head_slices).
#include "flash_common.cuh"
#include "hopper.cuh"

#include <type_traits>

namespace pt_flash {

// SPLIT (head_dim above 256, D = 256): the tensors' head_dim is
// gridDim.z * D and the block writes the D-column chunk blockIdx.z of O.
// The scores still take the whole head_dim: for each key tile the block
// streams Q and K through Qs and Ks chunk by chunk, and V's own chunk once.
// Only chunk 0 writes lse.
template <int D, typename Mask, bool SPLIT = false>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                 Layout lay, Mask heads_mask, float scale) {
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
  const int cz = SPLIT ? blockIdx.z : 0;  // the output chunk
  const float* qb = q + h * lay.q_hs;
  const float* kb = k + h * lay.k_hs;
  const float* vb = v + h * lay.k_hs + cz * D;

  if (!SPLIT) load_tile<BQ, D>(Qs, qb, q0, lay.sq, lay.q_rs);

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
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[i][b] = 0.f;
    // chunk cc of Q K^T (one pass unless SPLIT); V is loaded with chunk 0
    for (int cc = 0; cc < (SPLIT ? (int)gridDim.z : 1); ++cc) {
      __syncthreads();  // the last reads of Qs, Ks, Vs and Ps are done
      if (SPLIT) load_tile<BQ, D>(Qs, qb + cc * D, q0, lay.sq, lay.q_rs);
      load_tile<BK, D>(Ks, kb + cc * D, k0, lay.sk, lay.k_rs);
      if (cc == 0) load_tile<BK, D>(Vs, vb, k0, lay.sk, lay.k_rs);
      __syncthreads();
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
        Ps[(ty + 16 * i) * LDP + tx + 16 * b] = p;
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
    float* orow = o + h * lay.q_hs + qp * lay.q_rs + cz * D;
#pragma unroll
    for (int c = 0; c < DJ; ++c) orow[tx + 16 * c] = acc[i][c] / l_safe;
    if (tx == 0 && cz == 0)
      lse[(size_t)h * lay.sq + qp] = l[i] == 0.f ? Mask::empty_lse() : m[i] + logf(l[i]);
  }
}


// ------------------------------------------- the bf16 and fp16 tensor-core kernel

constexpr int HOP_NT = HOP_CONSUMERS + 32;  // the consumers and one producer warp

// The K/V ring of the tensor-core forward: 4 stages below D = 128, so that three
// blocks (the most their registers allow) fit an SM's shared memory, and 2
// at D = 128, so that two do; the Q tile, then stage s's K and V tiles,
// then the mbarriers.
template <int D>
struct FwdRing {
  static constexpr int STAGES = D == 128 ? 2 : 4;
  static constexpr size_t SMEM = 1024 + (size_t)HopTile<D>::BYTES * (1 + 2 * STAGES) +
                                 sizeof(uint64_t) * (1 + 2 * STAGES);
};

// One key tile's mask and online-softmax step on the S accumulator `sc`
// (rows r and r + 8 of the tile: h2 = 0, 1): masks S, updates the running
// max m of the scaled logits and this thread's part of the row sum l (the
// four threads of a row add theirs at the end), leaves P (fp32, 0 where
// masked) in `sc` and the factor by which the output rows must be rescaled
// in `alpha`. FULL: the mask keeps every pair of the tile
// (`Mask::tile_full`), so no element is tested. For scale > 0 the max is
// taken before scaling (max(s) * scale is max(s * scale) exactly, rounding
// being monotonic) and the scale folds into the exponent's FMA.
template <bool FULL, typename Mask>
__device__ __forceinline__ void softmax_tile(const Mask& mask, int j, const RowInfo (&qi)[2],
                                             int cq, float scale, float (&sc)[32], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2]) {
  const bool pre = !(scale > 0.f);  // a scale <= 0 is applied before the max
  const float post = pre ? 1.f : scale;
  if (pre) {
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] *= scale;
  }
  uint32_t vis = ~0u;  // bit i: S value i is seen
  float mx[2] = {NEG_INF, NEG_INF};
  if (FULL) {
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
  } else {
    vis = 0;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const RowInfo ki = mask.k_row(j * BK + 8 * jj + cq + e);
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int i = 4 * jj + 2 * h2 + e;
          const bool ok = mask.visible(qi[h2], ki);
          vis |= (uint32_t)ok << i;
          mx[h2] = fmaxf(mx[h2], ok ? sc[i] : NEG_INF);
        }
      }
  }
  const float post_log2 = post * LOG2E;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    // a row with nothing seen yet keeps a max at or below -1e30 * post; its
    // alpha and p are then 0 and its l stays 0
    const float m_new = fmaxf(m[h2], quad_max(mx[h2]) * post);
    alpha[h2] = exp2_ftz((m[h2] - m_new) * LOG2E);
    const float m_log2 = m_new * LOG2E;
    float rs = 0.f;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * jj + 2 * h2 + e;
        const float e2 = exp2_ftz(fmaf(sc[i], post_log2, -m_log2));
        const float p = FULL || ((vis >> i) & 1u) ? e2 : 0.f;
        rs += p;
        sc[i] = p;
      }
    l[h2] = alpha[h2] * l[h2] + rs;
    m[h2] = m_new;
  }
}

template <typename Mask>
__device__ __forceinline__ void softmax_tile(const Mask& mask, int qt, int j,
                                             const RowInfo (&qi)[2], int cq, float scale,
                                             float (&sc)[32], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2]) {
  if (mask.tile_full(qt, j))
    softmax_tile<true>(mask, j, qi, cq, scale, sc, m, l, alpha);
  else
    softmax_tile<false>(mask, j, qi, cq, scale, sc, m, l, alpha);
}

// S = Q K^T of one key tile into `sc`: started and committed, not waited.
template <int D, typename T>
__device__ __forceinline__ void start_qk(float (&sc)[32], uint32_t q_addr, uint32_t k_addr) {
  wgmma_nt<D, T>(sc, q_addr, k_addr);
  pt_hopper::wgmma_commit();
}

// The one-warpgroup form (head_dim 32, 64, 128), io type T.
template <int D, typename T, typename Mask>
__device__ __forceinline__ void fwd_narrow(const CUtensorMap* tm_q, const CUtensorMap* tm_k,
                                           const CUtensorMap* tm_v, T* __restrict__ o,
                                           float* __restrict__ lse, const Layout& lay,
                                           const Mask& heads_mask, float scale, int packed,
                                           int tiles_x) {
  using Tile = HopTile<D>;
  constexpr int STAGES = FwdRing<D>::STAGES;
  using namespace pt_hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align_1024(smem_raw);
  uint8_t* KVs = Qs + Tile::BYTES;  // stage s: K at 2 s tiles on, V one tile after
  uint64_t* q_full = reinterpret_cast<uint64_t*>(KVs + 2 * STAGES * Tile::BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  // the grid's x axis walks the heads or the query tiles (see fwd_hopper);
  // query tiles run last to first, the longest first under a causal mask
  const int h = tiles_x ? blockIdx.y : blockIdx.x;
  const int qt = tiles_x ? gridDim.x - 1 - blockIdx.x : gridDim.y - 1 - blockIdx.y;
  const int q0 = qt * BQ;
  const Mask mask = heads_mask.at_head(h);
  const int2 tiles = mask.key_tiles(qt);
  // the key tiles visited, in order: producer and consumer walk the same list
  auto next_tile = [&](int j) {
    for (++j; j < tiles.y && !mask.tile_open(qt, j); ++j) {
    }
    return j;
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, HOP_CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= HOP_CONSUMERS) {  // the producer warp; its first lane works
    if (threadIdx.x == HOP_CONSUMERS) {
      tma_prefetch_map(tm_q);
      tma_prefetch_map(tm_k);
      tma_prefetch_map(tm_v);
      mbar_arrive_expect_tx(q_full, Tile::BYTES);
      tma_tile<D>(Qs, tm_q, q_full, q0, h, packed);
      int it = 0;
      for (int j = next_tile(tiles.x - 1); j < tiles.y; j = next_tile(j), ++it) {
        const int s = it % STAGES;
        mbar_wait(empty + s, ((it / STAGES) & 1) ^ 1);  // round 0 passes at once
        mbar_arrive_expect_tx(full + s, 2 * Tile::BYTES);
        uint8_t* Ks = KVs + 2 * s * Tile::BYTES;
        tma_tile<D>(Ks, tm_k, full + s, j * BK, h, packed);
        tma_tile<D>(Ks + Tile::BYTES, tm_v, full + s, j * BK, h, packed);
      }
    }
    return;
  }

  // The consumer warpgroup: thread t holds rows r and r + 8 of the tile and,
  // of each 8 columns of S or O, the pair at 2 * (t % 4). Per key tile j
  // (ring stage s) the products of two tiles are in flight together: S of
  // the next tile and P V of this one, so the next tile's softmax runs
  // while the tensor cores do this tile's P V.
  const int t = threadIdx.x;
  const int r = 16 * (t / 32) + (t % 32) / 4;
  const int cq = 2 * (t % 4);
  const uint32_t q_addr = smem_u32(Qs);
  auto k_addr = [&](int s) { return smem_u32(KVs + 2 * s * Tile::BYTES); };

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const RowInfo qi[2] = {mask.q_row(q0 + r), mask.q_row(q0 + r + 8)};

  mbar_wait(q_full, 0);
  int j = next_tile(tiles.x - 1);
  if (j < tiles.y) {
    float sc[32], alpha[2];
    uint32_t pa[4][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    // P of the tile whose softmax just ran, as the A operand: its k-th 16
    // keys are S values 8k .. 8k + 7
    auto pack_p = [&] {
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int x = 0; x < 4; ++x) pa[k][x] = pack2<T>(sc[8 * k + 2 * x], sc[8 * k + 2 * x + 1]);
    };
    auto start_pv = [&](int s) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        wgmma_rs_d<D, T>(acc, pa[k], Tile::mn_major(k_addr(s) + Tile::BYTES, k));
      wgmma_commit();
    };
    mbar_wait(full, 0);
    fence_regs(sc);
    wgmma_fence();
    start_qk<D, T>(sc, q_addr, k_addr(0));
    wgmma_wait<0>();
    fence_regs(sc);
    softmax_tile(mask, qt, j, qi, cq, scale, sc, m, l, alpha);  // acc is 0: no rescale
    int it = 0;
    // tile j (stage s) and the next one, jn (stage sn), each pass: S of jn
    // and P V of j in flight together, the softmax of jn under P V of j
    for (int jn = next_tile(j); jn < tiles.y; j = jn, jn = next_tile(j), ++it) {
      const int s = it % STAGES, sn = (it + 1) % STAGES;
      pack_p();
      mbar_wait(full + sn, ((it + 1) / STAGES) & 1);
      fence_regs(sc);
      fence_regs(acc);
      wgmma_fence();
      start_qk<D, T>(sc, q_addr, k_addr(sn));
      start_pv(s);
      wgmma_wait<1>();  // S of jn; P V of j may still run
      fence_regs(sc);
      softmax_tile(mask, qt, jn, qi, cq, scale, sc, m, l, alpha);
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int k = 0; k < 4; ++k) fence_regs(pa[k]);
      mbar_arrive(empty + s);
#pragma unroll
      for (int jd = 0; jd < D / 8; ++jd)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          acc[4 * jd + 2 * h2] *= alpha[h2];
          acc[4 * jd + 2 * h2 + 1] *= alpha[h2];
        }
    }
    // the last tile's P V
    pack_p();
    fence_regs(acc);
    wgmma_fence();
    start_pv(it % STAGES);
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(empty + it % STAGES);
  }

#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) l[h2] = quad_sum(l[h2]);
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int qp = q0 + r + 8 * h2;
    if (qp >= lay.sq) continue;
    const float inv_l = 1.f / (l[h2] == 0.f ? 1.f : l[h2]);  // one division a row
    T* orow = o + h * lay.q_hs + (long long)qp * lay.q_rs + cq;
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd)
      *reinterpret_cast<uint32_t*>(orow + 8 * jd) =
          pack2<T>(acc[4 * jd + 2 * h2] * inv_l, acc[4 * jd + 2 * h2 + 1] * inv_l);
    if ((t & 3) == 0)
      lse[(size_t)h * lay.sq + qp] = l[h2] == 0.f ? Mask::empty_lse() : m[h2] + logf(l[h2]);
  }
}

// ----------------------------- the bf16 and fp16 tensor-core kernel, head_dim 256

// The head_dim-256 form (WIDE_NT threads, WideSmem and RingPos in
// flash_common.cuh): 128 query rows (two 64-row tiles, one per consumer
// warpgroup) of head h and the 256-column output chunk cz of `chunks`
// (SPLIT; 1 otherwise), io type T. See the notes at the top of the file.
template <typename T, typename Mask, bool SPLIT>
__device__ __forceinline__ void fwd_wide(const CUtensorMap* tm_q, const CUtensorMap* tm_k,
                                         const CUtensorMap* tm_v, T* __restrict__ o,
                                         float* __restrict__ lse, const Layout& lay,
                                         const Mask& heads_mask, float scale, int packed,
                                         int tiles_x, int chunks) {
  using Tile = HopTile<256>;
  using namespace pt_hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* bufs = align_1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(bufs + WideSmem::BARRIERS);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + WideSmem::BUFS;

  const int n = SPLIT ? chunks : 1;
  const bool q_res = n <= 2;  // Q's chunks resident, two tiles each; else streamed
  const int q_bufs = q_res ? 2 * n : 0;
  uint8_t* ring = bufs + q_bufs * Tile::BYTES;
  const int slots = WideSmem::BUFS - q_bufs;
  const int per_chunk = q_res ? 1 : 3;     // fills a chunk of S: [Q_c, Q_c',] K_c
  const int per_tile = per_chunk * n + 1;  // and V's own chunk

  // the grid's tile axis holds (query block, chunk), the chunk fastest, so
  // the chunks of one block, which read the same Q and K, run side by side;
  // query blocks run last to first, the longest first under a causal mask
  const int h = tiles_x ? blockIdx.y : blockIdx.x;
  const int tile = tiles_x ? blockIdx.x : blockIdx.y;
  const int ext = tiles_x ? gridDim.x : gridDim.y;
  const int cz = SPLIT ? tile % n : 0;
  const int qb = ext / n - 1 - tile / n;
  const int q0 = qb * WIDE_BQ;
  const int nqt = (lay.sq + BQ - 1) / BQ;
  const Mask mask = heads_mask.at_head(h);

  // key tiles [x, y) of query tiles 2 qb and 2 qb + 1 (none past the end),
  // and the block's list: every key tile either visits, in order
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

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < WideSmem::BUFS; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, WIDE_NT);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // The loads, issued by thread 0 in the order both warpgroups take them:
  // per key tile of the list, [Q_c, Q_c',] K_c for each chunk c, then V's
  // own chunk. `issue(need)` issues every fill up to index `need` (waiting
  // for its slot to be handed back by both warpgroups if it must) and, past
  // it, as many more as have a free slot. Its state stays in registers:
  // the backward's WideRing (flash_common.cuh) keeps it in shared memory to
  // free registers, and the forward, which has registers to spare, ran
  // 4-9% slower that way on the H100.
  int iss_tile = next_tile(lo - 1), iss_fill = 0, issued = 0;
  RingPos ip{0, 0, slots};
  auto issue = [&](int need) {
    while (iss_tile < hi) {
      if (!mbar_test(empty + ip.slot, ip.phase ^ 1)) {  // round 0 passes at once
        if (issued > need) return;
        mbar_wait(empty + ip.slot, ip.phase ^ 1);
      }
      const int c = iss_fill / per_chunk, sub = iss_fill % per_chunk;
      const bool is_v = iss_fill == per_tile - 1;
      const CUtensorMap* map = is_v ? tm_v : sub + 1 < per_chunk ? tm_q : tm_k;
      const int row = is_v || sub + 1 == per_chunk ? iss_tile * BK : q0 + sub * BQ;
      mbar_arrive_expect_tx(full + ip.slot, Tile::BYTES);
      tma_tile<256>(ring + ip.slot * Tile::BYTES, map, full + ip.slot, row, h, packed,
                    (is_v ? cz : c) * 256);
      ip.next();
      ++issued;
      if (++iss_fill == per_tile) {
        iss_fill = 0;
        iss_tile = next_tile(iss_tile);
      }
    }
  };
  if (threadIdx.x == 0) {
    tma_prefetch_map(tm_q);
    tma_prefetch_map(tm_k);
    tma_prefetch_map(tm_v);
    if (q_res) {
      mbar_arrive_expect_tx(q_full, q_bufs * Tile::BYTES);
      for (int c = 0; c < n; ++c)
        for (int w = 0; w < 2; ++w)
          tma_tile<256>(bufs + (2 * c + w) * Tile::BYTES, tm_q, q_full, q0 + w * BQ, h, packed,
                        c * 256);
    }
  }

  // A consumer warpgroup: query tile qt = 2 qb + w. Thread t holds rows r
  // and r + 8 of the tile and, of each 8 columns of S or O, the pair at
  // 2 * (t % 4).
  const int w = threadIdx.x / HOP_CONSUMERS;
  const int t = threadIdx.x % HOP_CONSUMERS;
  const int qt = 2 * qb + w;
  const int r = 16 * (t / 32) + (t % 32) / 4;
  const int cq = 2 * (t % 4);
  const int row0 = q0 + w * BQ;

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  RowInfo qi[2] = {};
  if (qt < nqt) {
    qi[0] = mask.q_row(row0 + r);
    qi[1] = mask.q_row(row0 + r + 8);
  }
  uint32_t pa[4][4];

  if (q_res) mbar_wait(q_full, 0);
  RingPos p{0, 0, slots};
  int taken = 0;
  auto take = [&] {  // the next fill, once it has arrived
    if (threadIdx.x == 0) issue(taken);
    mbar_wait(full + p.slot, p.phase);
    const int s = p.slot;
    p.next();
    ++taken;
    return s;
  };
  auto slot_addr = [&](int s) { return smem_u32(ring + s * Tile::BYTES); };
#pragma unroll 1
  for (int j = next_tile(lo - 1); j < hi; j = next_tile(j)) {
    const bool mine = visits(w, j);
    // S, a fresh accumulator each tile: no S lives through the P V below
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    // S = sum over chunks c of Q_c K_c^T; each chunk's slots handed back
    // as soon as its products are done
#pragma unroll 1
    for (int c = 0; c < n; ++c) {
      int qs0 = 0, qs1 = 0;
      if (!q_res) {
        qs0 = take();
        qs1 = take();
      }
      const int ks = take();
      if (mine) {
        uint32_t q_addr = q_res ? smem_u32(bufs + (2 * c + w) * Tile::BYTES)
                                : slot_addr(w ? qs1 : qs0);
        // recomputed each tile: Q's 16 descriptors kept across the loop
        // would hold 16 registers the accumulators need
        asm volatile("" : "+r"(q_addr));
        fence_regs(sc);
        wgmma_fence();
        wgmma_nt<256, T>(sc, q_addr, slot_addr(ks), c > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
      }
      if (!q_res) {
        mbar_arrive(empty + qs0);
        mbar_arrive(empty + qs1);
      }
      mbar_arrive(empty + ks);
    }
    if (mine) {
      float alpha[2];
      softmax_tile(mask, qt, j, qi, cq, scale, sc, m, l, alpha);
#pragma unroll
      for (int jd = 0; jd < 32; ++jd)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          acc[4 * jd + 2 * h2] *= alpha[h2];
          acc[4 * jd + 2 * h2 + 1] *= alpha[h2];
        }
      // P as the A operand: its k-th 16 keys are S values 8k .. 8k + 7
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int x = 0; x < 4; ++x) pa[k][x] = pack2<T>(sc[8 * k + 2 * x], sc[8 * k + 2 * x + 1]);
    }
    const int vs = take();
    if (mine) {
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k)
        wgmma_rs_d<256, T>(acc, pa[k], Tile::mn_major(slot_addr(vs), k));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int k = 0; k < 4; ++k) fence_regs(pa[k]);
    }
    mbar_arrive(empty + vs);
  }
  // the fills the other warpgroup still takes
  if (threadIdx.x == 0) issue(INT_MAX);

#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) l[h2] = quad_sum(l[h2]);
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int qp = row0 + r + 8 * h2;
    if (qp >= lay.sq) continue;
    const float inv_l = 1.f / (l[h2] == 0.f ? 1.f : l[h2]);
    T* orow = o + h * lay.q_hs + (long long)qp * lay.q_rs + cz * 256 + cq;
#pragma unroll
    for (int jd = 0; jd < 32; ++jd)
      *reinterpret_cast<uint32_t*>(orow + 8 * jd) =
          pack2<T>(acc[4 * jd + 2 * h2] * inv_l, acc[4 * jd + 2 * h2 + 1] * inv_l);
    if ((t & 3) == 0 && cz == 0)
      lse[(size_t)h * lay.sq + qp] = l[h2] == 0.f ? Mask::empty_lse() : m[h2] + logf(l[h2]);
  }
}

// The tensor-core kernel, io type T (bf16 or fp16): the one-warpgroup form
// below head_dim 256, the two-warpgroup form at 256 (SPLIT: one 256-column
// chunk of a wider head_dim, `chunks` of them).
template <int D, typename T, typename Mask, bool SPLIT = false>
__global__ void __launch_bounds__(D == 256 ? WIDE_NT : HOP_NT, D == 256 ? 1 : D == 128 ? 2 : 3)
flash_fwd_hopper(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, T* __restrict__ o,
                 float* __restrict__ lse, Layout lay, Mask heads_mask, float scale, int packed,
                 int tiles_x, int chunks) {
  static_assert(D == 256 || !SPLIT, "SPLIT is the head_dim-256 form's");
  if constexpr (D == 256)
    fwd_wide<T, Mask, SPLIT>(&tm_q, &tm_k, &tm_v, o, lse, lay, heads_mask, scale, packed,
                             tiles_x, chunks);
  else
    fwd_narrow<D, T, Mask>(&tm_q, &tm_k, &tm_v, o, lse, lay, heads_mask, scale, packed, tiles_x);
}

template <int D, typename T, typename Mask>
cudaError_t fwd_hopper(const void* q, const void* k, const void* v, void* o, void* lse,
                       int heads, Layout lay, Mask mask, float scale, int packed, void* stream) {
  using Ring = FwdRing<D>;
  const int nqt = (lay.sq + BQ - 1) / BQ;
  // Fixed-length causal tiles of one head run side by side (x = query
  // tiles), so a head's K and V stay in L2 while its tiles read them; the
  // varlen and flashmask tiles, whose work varies from tile to tile, run
  // the heads side by side (x = heads), so every head's longest tiles start
  // in the first wave.
  // More than MAX_GRID_Y tiles go on x whatever the mask (x holds 2^31 - 1
  // blocks; by_head_slices keeps the heads on y within MAX_GRID_Y).
  const int tiles_x = std::is_same<Mask, CausalMask>::value || nqt > MAX_GRID_Y;
  const dim3 grid = tiles_x ? dim3(nqt, heads) : dim3(heads, nqt);
  if (heads < 1 || heads > MAX_GRID_Y || nqt < 1) return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  int err = hop_map<D, T>(&mq, q, lay.sq, heads, lay.q_rs, lay.q_hs, packed);
  if (!err) err = hop_map<D, T>(&mk, k, lay.sk, heads, lay.k_rs, lay.k_hs, packed);
  if (!err) err = hop_map<D, T>(&mv, v, lay.sk, heads, lay.k_rs, lay.k_hs, packed);
  if (err) return (cudaError_t)err;
  return launch_nt(flash_fwd_hopper<D, T, Mask>, grid, HOP_NT, Ring::SMEM, stream, mq, mk, mv,
                   (T*)o, (float*)lse, lay, mask, scale, packed, tiles_x, 1);
}

// The head_dim-256 form over `chunks` 256-column chunks of the head_dim
// (SPLIT when more than one).
template <typename T, typename Mask, bool SPLIT>
cudaError_t fwd_wide_launch(const void* q, const void* k, const void* v, void* o, void* lse,
                            int heads, Layout lay, Mask mask, float scale, int packed,
                            void* stream, int chunks) {
  const long long nqb = (lay.sq + WIDE_BQ - 1) / WIDE_BQ;
  const long long ext = nqb * chunks;
  // as fwd_hopper: fixed-length blocks of one head side by side, the
  // varlen and flashmask heads side by side, more than MAX_GRID_Y on x
  const int tiles_x = std::is_same<Mask, CausalMask>::value || ext > MAX_GRID_Y;
  if (heads < 1 || heads > MAX_GRID_Y || nqb < 1 || ext > INT_MAX || (chunks > 1) != SPLIT)
    return cudaErrorInvalidValue;
  const dim3 grid = tiles_x ? dim3((unsigned)ext, heads) : dim3(heads, (unsigned)ext);
  const int d = 256 * chunks;
  CUtensorMap mq, mk, mv;
  int err = hop_map<256, T>(&mq, q, lay.sq, heads, lay.q_rs, lay.q_hs, packed, d);
  if (!err) err = hop_map<256, T>(&mk, k, lay.sk, heads, lay.k_rs, lay.k_hs, packed, d);
  if (!err) err = hop_map<256, T>(&mv, v, lay.sk, heads, lay.k_rs, lay.k_hs, packed, d);
  if (err) return (cudaError_t)err;
  return launch_nt(flash_fwd_hopper<256, T, Mask, SPLIT>, grid, WIDE_NT, WideSmem::SMEM, stream,
                   mq, mk, mv, (T*)o, (float*)lse, lay, mask, scale, packed, tiles_x, chunks);
}

// ------------------------------------------------------ launch and entries

// The FMA kernel (float io); `chunks` > 1: the SPLIT kernel, one block per
// 256-column chunk of O.
template <int D, typename Mask, bool SPLIT = false>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o, void* lse, int heads,
                Layout lay, Mask mask, float scale, void* stream, int chunks = 1) {
  const size_t smem = sizeof(float) * (3 * 64 * (D + 1) + BQ * LDP);
  const dim3 grid((lay.sq + BQ - 1) / BQ, heads, chunks);
  return launch(flash_fwd_kernel<D, Mask, SPLIT>, grid, smem, stream, (const float*)q,
                (const float*)k, (const float*)v, (float*)o, (float*)lse, lay, mask, scale);
}

// bf16 and fp16 to the tensor-core kernel, float to the FMA kernel (io:
// see Io), chosen by io type at every head_dim; head_dim 256 to either
// kernel's 256 form, and a head_dim above 256 (a multiple of 256: the
// wrappers pad to it) to the same form split over it. `packed` says the
// tensors are [T, H, D] (varlen) rather than [BH, S, D]. One slice of at
// most MAX_GRID_Y heads.
template <typename Mask>
cudaError_t fwd_heads(int d, int io, const void* q, const void* k, const void* v, void* o,
                      void* lse, int heads, Layout lay, Mask mask, float scale, int packed,
                      void* stream) {
  if (d >= 256) {
    if (d % 256) return cudaErrorInvalidValue;
    const int chunks = d / 256;
    if (io == IO_F32)
      return chunks == 1 ? fwd<256>(q, k, v, o, lse, heads, lay, mask, scale, stream)
                         : fwd<256, Mask, true>(q, k, v, o, lse, heads, lay, mask, scale, stream,
                                                chunks);
    PT_FLASH_SWITCH_HOP_IO(io, return chunks == 1
                                   ? fwd_wide_launch<T, Mask, false>(q, k, v, o, lse, heads, lay,
                                                                     mask, scale, packed, stream,
                                                                     1)
                                   : fwd_wide_launch<T, Mask, true>(q, k, v, o, lse, heads, lay,
                                                                    mask, scale, packed, stream,
                                                                    chunks))
  }
  if (io == IO_F32) {
    PT_FLASH_SWITCH_D(d, return fwd<D>(q, k, v, o, lse, heads, lay, mask, scale, stream))
  }
  PT_FLASH_SWITCH_D(d, PT_FLASH_SWITCH_HOP_IO(io, return fwd_hopper<D, T>(q, k, v, o, lse, heads,
                                                                          lay, mask, scale,
                                                                          packed, stream)))
}

// fwd_heads over every slice of the heads (by_head_slices).
template <typename Mask>
cudaError_t fwd_any(int d, int io, const void* q, const void* k, const void* v, void* o,
                    void* lse, int heads, Layout lay, Mask mask, float scale, int packed,
                    void* stream) {
  const long long e = io_bytes(io);
  return by_head_slices(heads, [&](int h0, int n) {
    return fwd_heads(d, io, at(q, h0 * lay.q_hs, e), at(k, h0 * lay.k_hs, e),
                     at(v, h0 * lay.k_hs, e), at(o, h0 * lay.q_hs, e),
                     at(lse, (long long)h0 * lay.sq, 4), n, lay, mask.from_head(h0), scale,
                     packed, stream);
  });
}

}  // namespace pt_flash

// Every entry: bf16 and fp16 q, k and v start on 16-byte boundaries (their
// tensor maps need it; the wrappers see to it); a failed tensor-map encode returns the
// error code of libcuda, a refused launch cudaGetLastError().
//
// io: 0 float, 1 bf16, 2 fp16 (pt_flash::Io).
//
// q, k, v, o [bh, s, d] in the io type, contiguous;
// lse float [bh, sq]. Launches on `stream` and returns cudaGetLastError().
extern "C" int pt_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                            int bh, int sq, int sk, int d, int io, int causal, float scale,
                            int kv_len, int q_offset, void* stream) {
  const pt_flash::CausalMask mask{sq, causal, kv_len, q_offset};
  return (int)pt_flash::fwd_any(d, io, q, k, v, o, lse, bh,
                                pt_flash::dense_layout(sq, sk, d), mask, scale, 0, stream);
}

// q, o [tq, h, d] and k, v [tk, h, d] in the io type, contiguous; lse float
// [h, tq]. seg_q/pos_q int32 [ceil(tq / 64) * 64], seg_k/pos_k int32
// [ceil(tk / 64) * 64]; lo/hi int32 [ceil(tq / 64)]: the key tiles each
// query tile visits. Launches on `stream` and returns cudaGetLastError().
extern "C" int pt_varlen_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                             const int* seg_q, const int* pos_q, const int* seg_k,
                             const int* pos_k, const int* lo, const int* hi, int h, int tq,
                             int tk, int d, int io, int causal, float scale, void* stream) {
  const pt_flash::SegmentMask mask{seg_q, pos_q, seg_k, pos_k, lo, hi, causal};
  return (int)pt_flash::fwd_any(d, io, q, k, v, o, lse, h,
                                pt_flash::packed_layout(tq, tk, h, d), mask, scale, 1,
                                stream);
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
                                int io, int causal, float scale, void* stream) {
  const pt_flash::StartEndMask mask{st, en, st_max, en_min, h, hs, sq, sk, causal};
  return (int)pt_flash::fwd_any(d, io, q, k, v, o, lse, bh,
                                pt_flash::dense_layout(sq, sk, d), mask, scale, 0, stream);
}
