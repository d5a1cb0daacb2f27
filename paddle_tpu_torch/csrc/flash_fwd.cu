// Flash-attention forward for Hopper (sm_90a): fixed-length causal batches,
// packed variable-length sequences and flashmask (start/end row) masks, two
// kernels templated on the mask: a tensor-core kernel for bf16 io
// (`flash_fwd_hopper`) and an fp32 FMA kernel for float and fp16 io
// (`flash_fwd_kernel`). `fwd_any` sends bf16 to the first and float and
// fp16 to the second: the tensor cores have no fp32 product at fp32
// accuracy (TF32 keeps 10 mantissa bits), so float io stays on FMAs; fp16
// io shares the FMA kernel until it has `wgmma` instantiations of its own.
// head_dim 256 goes to the FMA kernel at every io type (214,016 bytes of
// shared memory a block); it has no tensor-core instantiation yet. A
// head_dim above 256 runs the same kernel split over it (SPLIT): one block
// per 256-column chunk of the output, the scores over the whole head_dim
// recomputed by every chunk's block.
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
// 68 MB (20 us): the operations.
//
// The bf16 kernel (`flash_fwd_hopper`), one block per (head, 64-row query
// tile), 160 threads: one consumer warpgroup and one producer warp.
// - The producer's first lane loads the Q tile with one TMA load (two at
//   D = 128) and streams K and V tiles through a ring of shared
//   memory stages, each signalled on a "full" mbarrier by the TMA's byte
//   count and handed back on an "empty" one by the 128 consumer threads.
//   TMA zero-fills rows past the tensor's end and swizzles the tiles the way
//   `wgmma` reads them (128 B rows, 64 B at D = 32). Producer and consumer
//   walk the same tile list: `key_tiles(qt)`, then `tile_open(qt, j)`.
// - S = Q K^T is D / 16 `wgmma` m64n64k16 from shared memory, both K-major;
//   O += P V is four m64nDk16 with P from registers (the S accumulator
//   rounded to bf16 in place, in its fragment order) and V as the
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
// 16 FMAs. It serves the fp32 and fp16 models and checks.
//
// Grid: FMA (ceil(Sq / 64), heads, head_dim / 256 above 256); bf16 the
// same for the fixed-length mask and (heads, ceil(Sq / 64)) for the varlen
// and flashmask masks; at most 65535 heads a launch (by_head_slices).
#include "flash_common.cuh"
#include "hopper.cuh"

#include <type_traits>

namespace pt_flash {

// SPLIT (head_dim above 256, D = 256): the tensors' head_dim is
// gridDim.z * D and the block writes the D-column chunk blockIdx.z of O.
// The scores still take the whole head_dim: for each key tile the block
// streams Q and K through Qs and Ks chunk by chunk, and V's own chunk once.
// Only chunk 0 writes lse.
template <typename T, int D, typename Mask, bool SPLIT = false>
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
  const int cz = SPLIT ? blockIdx.z : 0;  // the output chunk
  const T* qb = q + h * lay.q_hs;
  const T* kb = k + h * lay.k_hs;
  const T* vb = v + h * lay.k_hs + cz * D;

  if (!SPLIT) load_tile<T, BQ, D>(Qs, qb, q0, lay.sq, lay.q_rs);

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
      if (SPLIT) load_tile<T, BQ, D>(Qs, qb + cc * D, q0, lay.sq, lay.q_rs);
      load_tile<T, BK, D>(Ks, kb + cc * D, k0, lay.sk, lay.k_rs);
      if (cc == 0) load_tile<T, BK, D>(Vs, vb, k0, lay.sk, lay.k_rs);
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
    T* orow = o + h * lay.q_hs + qp * lay.q_rs + cz * D;
#pragma unroll
    for (int c = 0; c < DJ; ++c) orow[tx + 16 * c] = from_f<T>(acc[i][c] / l_safe);
    if (tx == 0 && cz == 0)
      lse[(size_t)h * lay.sq + qp] = l[i] == 0.f ? Mask::empty_lse() : m[i] + logf(l[i]);
  }
}


// ------------------------------------------------- the bf16 tensor-core kernel

constexpr int HOP_NT = HOP_CONSUMERS + 32;  // the consumers and one producer warp

// The K/V ring of the bf16 forward: 4 stages below D = 128, so that three
// blocks (the most their registers allow) fit an SM's shared memory, and 2
// at D = 128, so that two do; the Q tile, then stage s's K and V tiles,
// then the mbarriers.
template <int D>
struct FwdRing {
  static constexpr int STAGES = D == 128 ? 2 : 4;
  static constexpr size_t SMEM = 1024 + (size_t)HopTile<D>::BYTES * (1 + 2 * STAGES) +
                                 sizeof(uint64_t) * (1 + 2 * STAGES);
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

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
template <int D>
__device__ __forceinline__ void start_qk(float (&sc)[32], uint32_t q_addr, uint32_t k_addr) {
  wgmma_nt<D>(sc, q_addr, k_addr);
  pt_hopper::wgmma_commit();
}

template <int D, typename Mask>
__global__ void __launch_bounds__(HOP_NT, D == 128 ? 2 : 3)
flash_fwd_hopper(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, Layout lay, Mask heads_mask, float scale, int packed,
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
      tma_prefetch_map(&tm_q);
      tma_prefetch_map(&tm_k);
      tma_prefetch_map(&tm_v);
      mbar_arrive_expect_tx(q_full, Tile::BYTES);
      tma_tile<D>(Qs, &tm_q, q_full, q0, h, packed);
      int it = 0;
      for (int j = next_tile(tiles.x - 1); j < tiles.y; j = next_tile(j), ++it) {
        const int s = it % STAGES;
        mbar_wait(empty + s, ((it / STAGES) & 1) ^ 1);  // round 0 passes at once
        mbar_arrive_expect_tx(full + s, 2 * Tile::BYTES);
        uint8_t* Ks = KVs + 2 * s * Tile::BYTES;
        tma_tile<D>(Ks, &tm_k, full + s, j * BK, h, packed);
        tma_tile<D>(Ks + Tile::BYTES, &tm_v, full + s, j * BK, h, packed);
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
        for (int x = 0; x < 4; ++x) pa[k][x] = pack_bf16(sc[8 * k + 2 * x], sc[8 * k + 2 * x + 1]);
    };
    auto start_pv = [&](int s) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        wgmma_rs_d<D>(acc, pa[k], Tile::mn_major(k_addr(s) + Tile::BYTES, k));
      wgmma_commit();
    };
    mbar_wait(full, 0);
    fence_regs(sc);
    wgmma_fence();
    start_qk<D>(sc, q_addr, k_addr(0));
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
      start_qk<D>(sc, q_addr, k_addr(sn));
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
    __nv_bfloat16* orow = o + h * lay.q_hs + (long long)qp * lay.q_rs + cq;
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * jd) = __floats2bfloat162_rn(
          acc[4 * jd + 2 * h2] * inv_l, acc[4 * jd + 2 * h2 + 1] * inv_l);
    if ((t & 3) == 0)
      lse[(size_t)h * lay.sq + qp] = l[h2] == 0.f ? Mask::empty_lse() : m[h2] + logf(l[h2]);
  }
}

template <int D, typename Mask>
cudaError_t fwd_hopper(const void* q, const void* k, const void* v, void* o, void* lse,
                       int heads, Layout lay, Mask mask, float scale, int packed, void* stream) {
  using Ring = FwdRing<D>;
  const int nqt = (lay.sq + BQ - 1) / BQ;
  // Fixed-length causal tiles of one head run side by side (x = query
  // tiles), so a head's K and V stay in L2 while its tiles read them; the
  // varlen and flashmask tiles, whose work varies from tile to tile, run
  // the heads side by side (x = heads), so every head's longest tiles start
  // in the first wave.
  const int tiles_x = std::is_same<Mask, CausalMask>::value;
  const dim3 grid = tiles_x ? dim3(nqt, heads) : dim3(heads, nqt);
  if (grid.y > 65535 || heads < 1 || nqt < 1) return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  int err = hop_map<D>(&mq, q, lay.sq, heads, lay.q_rs, lay.q_hs, packed);
  if (!err) err = hop_map<D>(&mk, k, lay.sk, heads, lay.k_rs, lay.k_hs, packed);
  if (!err) err = hop_map<D>(&mv, v, lay.sk, heads, lay.k_rs, lay.k_hs, packed);
  if (err) return (cudaError_t)err;
  return launch_nt(flash_fwd_hopper<D, Mask>, grid, HOP_NT, Ring::SMEM, stream, mq, mk, mv,
                   (__nv_bfloat16*)o, (float*)lse, lay, mask, scale, packed, tiles_x);
}

// ------------------------------------------------------ launch and entries

// `chunks` > 1: the SPLIT kernel, one block per 256-column chunk of O.
template <typename T, int D, typename Mask, bool SPLIT = false>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o, void* lse, int heads,
                Layout lay, Mask mask, float scale, void* stream, int chunks = 1) {
  const size_t smem = sizeof(float) * (3 * 64 * (D + 1) + BQ * LDP);
  const dim3 grid((lay.sq + BQ - 1) / BQ, heads, chunks);
  return launch(flash_fwd_kernel<T, D, Mask, SPLIT>, grid, smem, stream, (const T*)q,
                (const T*)k, (const T*)v, (T*)o, (float*)lse, lay, mask, scale);
}

// bf16 to the tensor-core kernel, float and fp16 to the FMA kernel (io:
// see Io); head_dim 256 to the FMA kernel at every io type, and a head_dim
// above 256 (a multiple of 256: the wrappers pad to it) to the FMA kernel
// split over it. `packed` says the tensors are [T, H, D] (varlen) rather
// than [BH, S, D]. One slice of at most MAX_GRID_Y heads.
template <typename Mask>
cudaError_t fwd_heads(int d, int io, const void* q, const void* k, const void* v, void* o,
                      void* lse, int heads, Layout lay, Mask mask, float scale, int packed,
                      void* stream) {
  if (d > 256) {
    if (d % 256) return cudaErrorInvalidValue;
    PT_FLASH_SWITCH_IO(io, return fwd<T, 256, Mask, true>(q, k, v, o, lse, heads, lay, mask,
                                                          scale, stream, d / 256))
  }
  if (d == 256) {
    PT_FLASH_SWITCH_IO(io, return fwd<T, 256>(q, k, v, o, lse, heads, lay, mask, scale, stream))
  }
  if (io == IO_BF16) {
    PT_FLASH_SWITCH_D(d, return fwd_hopper<D>(q, k, v, o, lse, heads, lay, mask, scale, packed,
                                              stream))
  }
  PT_FLASH_SWITCH_D(d, PT_FLASH_SWITCH_FMA_IO(io, return fwd<T, D>(q, k, v, o, lse, heads, lay,
                                                                   mask, scale, stream)))
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

// Every entry: bf16 q, k and v start on 16-byte boundaries (their tensor
// maps need it; the wrappers see to it); a failed tensor-map encode returns the
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
