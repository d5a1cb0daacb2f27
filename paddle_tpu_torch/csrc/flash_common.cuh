// Shared pieces of the flash-attention kernels (forward, dK/dV, dQ), for
// fixed-length batches and for packed variable-length sequences.
//
// Layout: element (head, row, c) of a query-like tensor (q, o, dO, dQ) is at
// `head * q_hs + row * q_rs + c`, of a key-like one (k, v, dK, dV) at
// `head * k_hs + row * k_rs + c`: [BH, S, D] has row stride D and head
// stride S * D, packed [T, H, D] row stride H * D and head stride D. Rows are
// contiguous in the io type (float, bf16 or fp16). lse and delta are float
// [heads, Sq]. Every block of the FMA kernels (fp32 io; the bf16 and fp16
// tensor-core kernels' layout is described with their pieces at the end of
// this file and in their sources) runs NT = 256 threads
// as a 16 x 16 grid (tx = tid % 16, ty = tid / 16); a thread owns rows
// {ty + 16 i} and columns {tx + 16 j} of each 64-row tile, so the 16 threads
// that share a row sit in one half-warp and reduce a row with four xor
// shuffles. At head_dim 256 the FMA backward holds its block's own 64-row
// tile as two 32-row passes, so that its fp32 tiles fit shared memory
// (DqFma, DkvFma).
//
// What a kernel may see is a Mask policy (CausalMask, SegmentMask,
// StartEndMask below): which key a query row sees, which tiles a tile
// visits (a range, then a per-tile test), whether a tile is kept whole
// (`tile_full`, so the mask need not be tested element by element), the lse
// of a row that sees no key, and the policy of one grid head (`at_head`, for
// masks whose arrays differ by head). The kernels are templates on it.
//
// The FMA kernels' tiles live in shared memory as float with one word of
// padding per row (stride D + 1), so a column read by 16 neighbouring
// threads hits 16 different banks; their products are fp32 FMAs from
// shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <climits>

#include "hopper.cuh"

namespace pt_flash {

constexpr int BQ = 64;            // query rows per tile
constexpr int BK = 64;            // key rows per tile
constexpr int NT = 256;           // threads per block
constexpr int LDP = BK + 1;       // stride of a [64 x 64] score tile in smem
constexpr float NEG_INF = -1e30f; // the TPU kernel's mask fill

// Row counts and element strides of the query-like and key-like tensors.
// Row strides are 32-bit (a row offset inside one head stays below 2^31
// elements; the varlen wrappers check it): with 64-bit ones the
// fixed-length forward spills registers at head_dim 64.
struct Layout {
  int sq, sk;
  int q_rs, k_rs;
  long long q_hs, k_hs;
};

// Rows [row0, row0 + ROWS) of a [rows, D] float matrix whose rows are `rs`
// elements apart into a smem tile of stride D + 1; rows past the end read
// as 0.
template <int ROWS, int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int row0,
                                          int rows, int rs) {
  constexpr int LD = D + 1;
  for (int idx = threadIdx.x; idx < ROWS * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const int gr = row0 + r;
    dst[r * LD + c] = gr < rows ? src[gr * rs + c] : 0.f;
  }
}

// Entries [row0, row0 + n) of a float row vector (lse, delta); past the end 0.
__device__ __forceinline__ void load_rowvec(float* dst, const float* __restrict__ src,
                                            int row0, int rows, int n) {
  for (int idx = threadIdx.x; idx < n; idx += NT) {
    const int gr = row0 + idx;
    dst[idx] = gr < rows ? src[gr] : 0.f;
  }
}

// Max and sum over the 16 lanes of a half-warp (one row of a tile).
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// What a mask reads of one row: its index (CausalMask), its segment and
// in-segment position (SegmentMask), or for a key its banned query rows
// [a, b) and its index c (StartEndMask). A kernel fetches it once per row.
struct RowInfo {
  int a, b, c;
};

// Fixed-length rows (the TPU `_fwd_kernel` family): key kp is seen by query
// qp when it lies inside kv_len and, when causal, on or below the
// bottom-right-aligned diagonal kp <= qp + q_offset (q_offset = Sk - Sq).
// Tiles past the diagonal are skipped; a row that sees no key keeps
// m = -1e30 as its lse.
struct CausalMask {
  int sq, causal, kv_len, q_offset;

  __device__ static float empty_lse() { return NEG_INF; }

  __device__ CausalMask at_head(int) const { return *this; }
  CausalMask from_head(int) const { return *this; }
  __device__ RowInfo q_row(int qp) const { return {qp, 0}; }
  __device__ RowInfo k_row(int kp) const { return {kp, 0}; }
  __device__ bool visible(RowInfo q, RowInfo k) const {
    return q.a < sq && k.a < kv_len && (!causal || k.a <= q.a + q_offset);
  }
  __device__ bool tile_open(int, int) const { return true; }
  // Whether every key of key tile kt is seen by every row of query tile qt
  // (rows past sq aside, which no kernel writes): the mask need not be
  // applied element by element there.
  __device__ bool tile_full(int qt, int kt) const {
    const int k_last = kt * BK + BK - 1;
    return k_last < kv_len && (!causal || k_last <= qt * BQ + q_offset);
  }
  // Key tiles [x, y) that query tile qt visits: up to one past the last key
  // any of its rows sees.
  __device__ int2 key_tiles(int qt) const {
    int end = kv_len;
    if (causal) end = min(end, min(qt * BQ + BQ, sq) - 1 + q_offset + 1);
    end = max(end, 0);
    return make_int2(0, (end + BK - 1) / BK);
  }
  // Query tiles [x, y) that key tile kt visits: from the first one that
  // reaches the diagonal; none when the tile lies wholly past kv_len.
  __device__ int2 query_tiles(int kt) const {
    const int k0 = kt * BK;
    int begin = 0;
    if (causal && k0 - q_offset > 0) begin = (k0 - q_offset) / BQ;
    return make_int2(begin, k0 < kv_len ? (sq + BQ - 1) / BQ : 0);
  }
};

// Packed variable-length sequences (the TPU `_v_*_kernel` family): key kp
// is seen by query qp when both lie in the same segment and, when causal,
// pos_k <= pos_q (top-left aligned inside the segment). seg/pos are int32
// per token, padded to a whole number of 64-row tiles; padding queries are
// segment -1 and padding keys -2, so they never meet. The tiles a tile
// visits come from per-tile [lo, hi) bounds worked out on the host side
// (key tiles per query tile for the forward and dQ, query tiles per key
// tile for dK/dV). A row that sees no key gets lse 0, as on the TPU.
struct SegmentMask {
  const int* seg_q;
  const int* pos_q;
  const int* seg_k;
  const int* pos_k;
  const int* lo;
  const int* hi;
  int causal;

  __device__ static float empty_lse() { return 0.f; }

  __device__ SegmentMask at_head(int) const { return *this; }
  SegmentMask from_head(int) const { return *this; }
  __device__ RowInfo q_row(int qp) const { return {seg_q[qp], pos_q[qp]}; }
  __device__ RowInfo k_row(int kp) const { return {seg_k[kp], pos_k[kp]}; }
  __device__ bool visible(RowInfo q, RowInfo k) const {
    return q.a == k.a && (!causal || k.b <= q.b);
  }
  __device__ int2 key_tiles(int qt) const { return make_int2(lo[qt], hi[qt]); }
  __device__ int2 query_tiles(int kt) const { return make_int2(lo[kt], hi[kt]); }
  __device__ bool tile_open(int, int) const { return true; }
  // Both tiles inside one segment (segment ids never decrease along the
  // tokens, padding comes last) and, when causal, the tile's last key at or
  // before its first query.
  __device__ bool tile_full(int qt, int kt) const {
    const int q0 = qt * BQ, k0 = kt * BK, s = seg_q[q0];
    return s >= 0 && seg_q[q0 + BQ - 1] == s && seg_k[k0] == s && seg_k[k0 + BK - 1] == s &&
           (!causal || pos_k[k0 + BK - 1] <= pos_q[q0]);
  }
};

// Flashmask (the TPU `_fm_*_kernel` family), [BH, S, D] rows: key kp bans
// the query rows [st[kp], en[kp]); key kp is seen by query qp when qp is
// not banned, kp < sk, and, when causal, kp <= qp (top-left aligned). st
// and en are int32 [B * hs, sk] with hs = 1 (one row shared by the H heads
// of a batch row, read in place) or hs = H, for grid head bh + head0 (a
// launch over a slice of the heads starts at head0); st_max and en_min are int32
// [B * hs, ceil(sk / 64)], the largest start and the smallest end over each
// 64-column key tile's real columns, worked out on the host side. A key
// tile whose every column bans every row of a query tile is skipped, as the
// TPU kernels skip a fully banned key block; the tile range is the causal
// one ([0, diagonal] for a query tile, [diagonal, end) for a key tile).
// Padding query rows (qp >= sq) need no test: their q, dO, lse and delta
// are 0, so whatever they see adds exact zeros and is never written. A row
// that sees no key gets lse 0, as on the TPU.
struct StartEndMask {
  const int* st;
  const int* en;
  const int* st_max;
  const int* en_min;
  int h, hs, sq, sk, causal;
  int head0 = 0;

  __device__ static float empty_lse() { return 0.f; }

  StartEndMask from_head(int h0) const {
    StartEndMask m = *this;
    m.head0 = head0 + h0;
    return m;
  }
  __device__ StartEndMask at_head(int grid_head) const {
    const int bh = grid_head + head0;
    const long long row = (long long)(bh / h) * hs + (hs == 1 ? 0 : bh % h);
    const long long nkt = (sk + BK - 1) / BK;
    StartEndMask m = *this;
    m.st += row * sk;
    m.en += row * sk;
    m.st_max += row * nkt;
    m.en_min += row * nkt;
    return m;
  }
  __device__ RowInfo q_row(int qp) const { return {qp, 0, 0}; }
  // a padding key (kp >= sk) bans every row
  __device__ RowInfo k_row(int kp) const {
    return kp < sk ? RowInfo{st[kp], en[kp], kp} : RowInfo{INT_MIN, INT_MAX, kp};
  }
  __device__ bool visible(RowInfo q, RowInfo k) const {
    return !(q.a >= k.a && q.a < k.b) && (!causal || k.c <= q.a);
  }
  __device__ int2 key_tiles(int qt) const {
    const int end = causal ? min(min(qt * BQ + BQ, sq), sk) : sk;
    return make_int2(0, (end + BK - 1) / BK);
  }
  __device__ int2 query_tiles(int kt) const {
    return make_int2(causal ? kt * BK / BQ : 0, (sq + BQ - 1) / BQ);
  }
  __device__ bool tile_open(int qt, int kt) const {
    const int q0 = qt * BQ;
    return !(st_max[kt] <= q0 && en_min[kt] >= min(q0 + BQ, sq));
  }
  // The plan keeps no statistic that shows a tile free of bans.
  __device__ bool tile_full(int, int) const { return false; }
};

// Sets the block's dynamic shared memory limit, then launches `threads`
// threads a block (the FMA kernels' NT by default).
template <typename Kernel, typename... Args>
cudaError_t launch_nt(Kernel kernel, dim3 grid, int threads, size_t smem, void* stream,
                      Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(args...);
  return cudaGetLastError();
}
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, void* stream, Args... args) {
  return launch_nt(kernel, grid, NT, smem, stream, args...);
}

// The io type of a C entry's tensors: 0 float (the FMA kernels), 1 bf16 and
// 2 fp16 (the tensor-core kernels).
enum Io : int { IO_F32 = 0, IO_BF16 = 1, IO_F16 = 2 };

inline long long io_bytes(int io) { return io == IO_F32 ? 4 : 2; }

// A grid's y axis holds at most 65535 blocks, and the FMA kernels and the
// fixed-length tensor-core kernels put the heads there. So every launch runs over
// slices of at most MAX_GRID_Y heads: `run(h0, n)` launches heads
// [h0, h0 + n), its tensors' pointers moved to head h0 (`at`) and its mask
// told where its heads start (`from_head`). One slice below 65536 heads.
constexpr int MAX_GRID_Y = 65535;

template <typename Run>
cudaError_t by_head_slices(int heads, Run run) {
  if (heads < 1) return cudaErrorInvalidValue;
  for (int h0 = 0; h0 < heads; h0 += MAX_GRID_Y) {
    const cudaError_t err = run(h0, heads - h0 < MAX_GRID_Y ? heads - h0 : MAX_GRID_Y);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// `p` moved on by `elems` elements of `bytes` bytes each.
inline const void* at(const void* p, long long elems, long long bytes) {
  return static_cast<const char*>(p) + elems * bytes;
}
inline void* at(void* p, long long elems, long long bytes) {
  return static_cast<char*>(p) + elems * bytes;
}

// The fixed-length layout: [bh, sq, d] and [bh, sk, d], contiguous.
inline Layout dense_layout(int sq, int sk, int d) {
  return Layout{sq, sk, d, d, (long long)sq * d, (long long)sk * d};
}

// The packed layout: [tq, h, d] and [tk, h, d], contiguous.
inline Layout packed_layout(int tq, int tk, int h, int d) {
  return Layout{tq, tk, h * d, h * d, d, d};
}

// Instantiates `body` for head_dim 32, 64 or 128; anything else is refused.
#define PT_FLASH_SWITCH_D(d, ...)                    \
  switch (d) {                                       \
    case 32: { constexpr int D = 32; __VA_ARGS__; }  \
    case 64: { constexpr int D = 64; __VA_ARGS__; }  \
    case 128: { constexpr int D = 128; __VA_ARGS__; } \
    default: return cudaErrorInvalidValue;           \
  }

// Instantiates `body` for the tensor-core kernels' io type T: bf16 or fp16;
// anything else is refused.
#define PT_FLASH_SWITCH_HOP_IO(io, ...)                    \
  switch (io) {                                            \
    case IO_BF16: { using T = __nv_bfloat16; __VA_ARGS__; } \
    case IO_F16: { using T = __half; __VA_ARGS__; }         \
    default: return cudaErrorInvalidValue;                 \
  }

// ------------------------------------------------ the tensor-core kernels
//
// Pieces shared by the tensor-core kernels (`flash_fwd_hopper`,
// `flash_bwd_dq_hopper`, `flash_bwd_dkv_hopper`): 64-row tiles of a 2-byte
// io type T (bf16, or fp16: the same sizes, descriptors and swizzle; only
// the products' PTX type and the tensor maps' element type differ) loaded
// by TMA and read with `wgmma` by warpgroups of consumers (one, or two at
// head_dim 256). Each kernel takes T as its second template argument.

constexpr int HOP_CONSUMERS = 128;  // one warpgroup
constexpr float LOG2E = 1.4426950408889634f;

// A 64-row tile of head_dim D (2-byte elements) in shared memory: BOXES boxes of W
// columns (one TMA load each), each 64 rows of W * 2 bytes, swizzled (128 B
// rows, 64 B at D = 32). One layout serves as either operand form, so one
// TMA-loaded tile of Q, K, V or dO serves every product that reads it.
template <int D>
struct HopTile {
  static constexpr int W = D < 64 ? D : 64;
  static constexpr int BOXES = D / W;
  static constexpr int ROW_BYTES = W * 2;
  static constexpr int BOX_BYTES = 64 * ROW_BYTES;
  static constexpr int BYTES = BOXES * BOX_BYTES;
  static constexpr pt_hopper::Swizzle SW = D < 64 ? pt_hopper::SWIZZLE_64B
                                                  : pt_hopper::SWIZZLE_128B;

  // The tile as a K-major operand (its rows along M or N, the reduction
  // along D): the k-th 16 columns of the reduction over D.
  __device__ static uint64_t k_major(uint32_t base, int k) {
    return pt_hopper::gmma_desc(base + (k * 16 / W) * BOX_BYTES + (k * 16 % W) * 2, 16,
                                8 * ROW_BYTES, SW);
  }
  // The tile as an MN-major operand (its rows along the reduction, D along
  // N, read with the transpose bit): the k-th 16 rows of the reduction.
  __device__ static uint64_t mn_major(uint32_t base, int k) {
    return pt_hopper::gmma_desc(base + k * 16 * ROW_BYTES, BOX_BYTES, 8 * ROW_BYTES, SW);
  }
};

// The first 1024-byte boundary at or after `p` (a swizzled tile's start).
__device__ __forceinline__ uint8_t* align_1024(void* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// acc[64 x D] += A[64 x 16] (registers) * B[16 x D] (an MN-major tile), in
// elements of type T.
template <int D, typename T>
__device__ __forceinline__ void wgmma_rs_d(float (&acc)[D / 2], const uint32_t (&a)[4],
                                           uint64_t db) {
  if constexpr (D == 32) pt_hopper::wgmma_rs_n32<T>(acc, a, db);
  if constexpr (D == 64) pt_hopper::wgmma_rs_n64<T>(acc, a, db);
  if constexpr (D == 128) pt_hopper::wgmma_rs_n128<T>(acc, a, db);
  if constexpr (D == 256) pt_hopper::wgmma_rs_n256<T>(acc, a, db);
}

// D = A B^T over D (D += A B^T with `add`): the D / 16 products of one
// 64 x 64 tile, both operands K-major tiles; started, not committed or
// waited.
template <int D, typename T>
__device__ __forceinline__ void wgmma_nt(float (&d)[32], uint32_t a_addr, uint32_t b_addr,
                                         bool add = false) {
#pragma unroll
  for (int k = 0; k < D / 16; ++k)
    pt_hopper::wgmma_ss_n64<T>(d, HopTile<D>::k_major(a_addr, k),
                               HopTile<D>::k_major(b_addr, k), add || k > 0);
}

// (lo, hi) rounded to a pair of T (bf16 or fp16), as 32 bits: an A-operand
// register, or two adjacent outputs.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (pt_hopper::is_f16<T>) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
}

// x and y as pairs of T, hi + lo: hi = T(x), lo = T(x - hi). In bf16 hi + lo
// keeps 16 of x's bits (a relative error of about 2^-17) where hi alone
// keeps 8 (2^-9). In fp16 it keeps 22 while lo is a normal number (|x| at
// or above 2^-3), else an absolute 2^-25 (fp16's subnormal spacing, 2^-24,
// halved): the fp16 backward scales what it splits into [2^14, 2^15) of
// its row's largest value first (ds_rows).
template <typename T>
__device__ __forceinline__ void pack_split(float x, float y, uint32_t& hi, uint32_t& lo) {
  hi = pack2<T>(x, y);
  float hx, hy;
  if constexpr (pt_hopper::is_f16<T>) {
    const __half2 h = *reinterpret_cast<const __half2*>(&hi);
    hx = __low2float(h);
    hy = __high2float(h);
  } else {
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&hi);
    hx = __low2float(h);
    hy = __high2float(h);
  }
  lo = pack2<T>(x - hx, y - hy);
}

// Max and sum over the 4 threads of a quad (one row of an accumulator).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// fp16 io, the backward's dS: scales rows r and r + 8 of a dS tile on an
// accumulator fragment (`ds`; a thread's value x lies in row (x >> 1) & 1:
// key rows of dK/dV's dS^T, query rows of dQ's dS) by a power of two each
// (`mul`, kept over the tiles and only ever lowered), so that a row's
// largest |dS| lies in [2^14, 2^15) when it is first reached: the hi/lo
// split then keeps 22 bits of it (dS follows dO's scale, 2^-12 and 2^8 of
// unit scale alike under a loss scaler). When a row's power falls, the
// output rows already summed in `acc` (dK or dQ, the same fragment layout)
// fall by the same ratio (exact: powers of two); the epilogue divides by
// `mul`.
template <int N>
__device__ __forceinline__ void ds_rows(float (&ds)[32], float (&mul)[2], float (&acc)[N]) {
  float mx[2] = {0.f, 0.f};
#pragma unroll
  for (int x = 0; x < 32; ++x) mx[(x >> 1) & 1] = fmaxf(mx[(x >> 1) & 1], fabsf(ds[x]));
  float ratio[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    // 2^(14 - floor(log2 max)), at most 2^100 (a row of zeros keeps its power)
    const int e = min(14 - ((__float_as_int(quad_max(mx[h2])) >> 23) - 127), 100);
    const float want = __int_as_float((127 + e) << 23);
    ratio[h2] = want < mul[h2] ? want / mul[h2] : 1.f;
    mul[h2] = fminf(mul[h2], want);
  }
  if (ratio[0] != 1.f || ratio[1] != 1.f) {
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        acc[4 * j + 2 * h2] *= ratio[h2];
        acc[4 * j + 2 * h2 + 1] *= ratio[h2];
      }
  }
#pragma unroll
  for (int x = 0; x < 32; ++x) ds[x] *= mul[(x >> 1) & 1];
}

// The largest power ds_rows starts from.
constexpr float DS_MUL_MAX = 0x1p100f;

// Loads the BOXES boxes of one 64-row tile starting at `row` of head `h`
// and at column `col` (a D-column chunk of a wider row); packed [T, H, D]
// maps are (D, H, T), fixed [BH, S, D] ones (D, S, BH).
template <int D>
__device__ __forceinline__ void tma_tile(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                         int row, int h, int packed, int col = 0) {
  using Tile = HopTile<D>;
#pragma unroll
  for (int b = 0; b < Tile::BOXES; ++b) {
    if (packed)
      pt_hopper::tma_load_3d(dst + b * Tile::BOX_BYTES, map, bar, col + b * Tile::W, h, row);
    else
      pt_hopper::tma_load_3d(dst + b * Tile::BOX_BYTES, map, bar, col + b * Tile::W, row, h);
  }
}

// 2^x by the special-function unit (ex2.approx.ftz: about 2 ulp, results
// below 2^-126 flushed to 0, far below what a bf16 P or an fp32 row sum
// keeps); the library's exp2f adds range handling around the same unit.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The tensor map of a q-like ([rows, cols] per head, cols = D unless the
// kernel reads a wider row in D-column chunks) tensor of T (bf16 or fp16):
// packed [rows, heads, cols] as (cols, heads, rows), fixed
// [heads, rows, cols] as (cols, rows, heads), with 64-row boxes of
// HopTile<D>::W columns.
template <int D, typename T>
int hop_map(CUtensorMap* map, const void* base, int rows, int heads, int rs, long long hs,
            int packed, int cols = D) {
  using Tile = HopTile<D>;
  const uint64_t dims[3] = {(uint64_t)cols, (uint64_t)(packed ? heads : rows),
                            (uint64_t)(packed ? rows : heads)};
  const uint64_t strides[2] = {2ull * (packed ? hs : rs), 2ull * (packed ? rs : hs)};
  const uint32_t box[3] = {(uint32_t)Tile::W, packed ? 1u : 64u, packed ? 64u : 1u};
  return pt_hopper::encode_3d(map, pt_hopper::tma_type<T>(), base, dims, strides, box,
                              Tile::SW);
}

// ------------------------------------- the tensor-core kernels at head_dim 256
//
// The tensor-core forward and backward at head_dim 256 (and their SPLIT forms over
// 256-column chunks of a wider head_dim) run two consumer warpgroups a
// block and nothing else: Hopper allocates registers a warpgroup at a time,
// so a producer warp would cost a third warpgroup's registers and cap every
// thread at 168 (the 128-register accumulators then spill); thread 0
// issues the TMA loads between its own products instead.
constexpr int WIDE_NT = 2 * HOP_CONSUMERS;
constexpr int WIDE_BQ = 2 * BQ;  // query rows a forward or dQ block

// Their shared memory: BUFS tiles of 64 rows x 256 2-byte columns (the resident
// tiles first, the ring after them), then the mbarriers (the resident
// tiles' one, and a "full" and an "empty" one per buffer), thread 0's
// issuing state (RingIssuer), and 1 KB in which each dK/dV warpgroup keeps
// its query tile's 64 lse and 64 delta values (unused by the others).
struct WideSmem {
  static constexpr int TILE = HopTile<256>::BYTES;
  static constexpr int BUFS = 7;
  static constexpr size_t BARRIERS = (size_t)TILE * BUFS;
  static constexpr size_t ISSUER = BARRIERS + sizeof(uint64_t) * (1 + 2 * BUFS);
  static constexpr size_t STATS = ISSUER + 32;
  static constexpr size_t SMEM = 1024 + STATS + sizeof(float) * WIDE_NT;
};

// A position in the ring: the slot and the parity of its round.
struct RingPos {
  int slot, phase, slots;
  __device__ void next() {
    if (++slot == slots) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// Thread 0's side of the backward's ring, in shared memory (in registers,
// every thread would hold it beside the accumulators): the position of
// the next fill to issue (`tile`, and `fill` within it: the kernel's own
// cursor), the fills issued and taken, and the slot.
struct RingIssuer {
  int tile, fill, issued, taken;
  RingPos pos;
};

// The backward's ring of `slots` WideSmem tiles at `base` (the forward
// keeps the same logic in `fwd_wide`, its issuing state in registers):
// fills are numbered in the order both warpgroups take them, every thread
// takes every fill (waiting on its "full" barrier, which the TMA's byte
// count completes) and hands it back (its "empty" barrier counts all
// WIDE_NT threads). Thread 0 issues the fills from `take`: `more(is)` says
// whether one is left, `load(is, dst, bar)` issues the next one's TMA
// loads and moves the cursor on.
template <typename More, typename Load>
struct WideRing {
  uint8_t* base;
  uint64_t* full;
  uint64_t* empty;
  RingIssuer* is;
  More more;
  Load load;
  RingPos p;  // where this thread takes next

  __device__ uint32_t addr(int s) const {
    return pt_hopper::smem_u32(base + s * WideSmem::TILE);
  }
  // Thread 0: every fill up to index `need` (waiting for its slot to be
  // handed back by both warpgroups if it must) and, past it, as many more
  // as have a free slot.
  __device__ void issue(int need) {
    using namespace pt_hopper;
    RingIssuer& st = *is;
    while (more(st)) {
      if (!mbar_test(empty + st.pos.slot, st.pos.phase ^ 1)) {  // round 0 passes at once
        if (st.issued > need) return;
        mbar_wait(empty + st.pos.slot, st.pos.phase ^ 1);
      }
      mbar_arrive_expect_tx(full + st.pos.slot, WideSmem::TILE);
      load(st, base + st.pos.slot * WideSmem::TILE, full + st.pos.slot);
      st.pos.next();
      ++st.issued;
    }
  }
  // The next fill's slot, once it has arrived.
  __device__ int take() {
    if (threadIdx.x == 0) issue(is->taken++);
    pt_hopper::mbar_wait(full + p.slot, p.phase);
    const int s = p.slot;
    p.next();
    return s;
  }
  __device__ void release(int s) { pt_hopper::mbar_arrive(empty + s); }
};

// The ring over the `slots` buffers from `first` of the WideSmem block at
// `bufs`, its cursor starting at key or query tile `tile`. Thread 0
// initialises its issuer and every mbarrier (the resident tiles' one
// first), then the whole block waits.
template <typename More, typename Load>
__device__ __forceinline__ WideRing<More, Load> wide_ring(uint8_t* bufs, int first, int tile,
                                                        More more, Load load) {
  using namespace pt_hopper;
  uint64_t* res_full = reinterpret_cast<uint64_t*>(bufs + WideSmem::BARRIERS);
  RingIssuer* is = reinterpret_cast<RingIssuer*>(bufs + WideSmem::ISSUER);
  const int slots = WideSmem::BUFS - first;
  if (threadIdx.x == 0) {
    *is = RingIssuer{tile, 0, 0, 0, {0, 0, slots}};
    mbar_init(res_full, 1);
    for (int s = 0; s < WideSmem::BUFS; ++s) {
      mbar_init(res_full + 1 + s, 1);
      mbar_init(res_full + 1 + WideSmem::BUFS + s, WIDE_NT);
    }
    mbar_fence_init();
  }
  __syncthreads();
  return WideRing<More, Load>{bufs + first * WideSmem::TILE,
                              res_full + 1,
                              res_full + 1 + WideSmem::BUFS,
                              is,
                              more,
                              load,
                              {0, 0, slots}};
}

}  // namespace pt_flash
