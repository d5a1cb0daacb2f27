// Shared pieces of the flash-attention kernels (forward, dK/dV, dQ), for
// fixed-length batches and for packed variable-length sequences.
//
// Layout: element (head, row, c) of a query-like tensor (q, o, dO, dQ) is at
// `head * q_hs + row * q_rs + c`, of a key-like one (k, v, dK, dV) at
// `head * k_hs + row * k_rs + c`: [BH, S, D] has row stride D and head
// stride S * D, packed [T, H, D] row stride H * D and head stride D. Rows are
// contiguous in the io type (float, bf16 or fp16). lse and delta are float
// [heads, Sq]. Every block of the FMA kernels (fp32 and fp16 io; the bf16
// tensor-core kernels' layout is described with their pieces at the end of
// this file and in their sources) runs NT = 256 threads
// as a 16 x 16 grid (tx = tid % 16, ty = tid / 16); a thread owns rows
// {ty + 16 i} and columns {tx + 16 j} of each 64-row tile, so the 16 threads
// that share a row sit in one half-warp and reduce a row with four xor
// shuffles. At head_dim 256 (the FMA kernels at every io type) the
// backward holds its block's own 64-row tile as two 32-row passes, so that
// its fp32 tiles fit shared memory (DqFma, DkvFma).
//
// What a kernel may see is a Mask policy (CausalMask, SegmentMask,
// StartEndMask below): which key a query row sees, which tiles a tile
// visits (a range, then a per-tile test), whether a tile is kept whole
// (`tile_full`, so the mask need not be tested element by element), the lse
// of a row that sees no key, and the policy of one grid head (`at_head`, for
// masks whose arrays differ by head). The kernels are templates on it.
//
// Tiles live in shared memory as float with one word of padding per row
// (stride D + 1), so a column read by 16 neighbouring threads hits 16
// different banks. Products are fp32 FMAs from shared memory: the same
// numbers the TPU kernel gets from fp32-accumulating MXU products of
// io-typed inputs, since a product of two bf16 or fp16 values is exact in
// fp32.
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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) { return __float2half_rn(x); }

// x rounded to the io type and widened again (P before P.V, as the TPU
// kernel casts p to v's dtype before its second product).
template <typename T> __device__ __forceinline__ float round_io(float x) {
  return to_f(from_f<T>(x));
}

// Row counts and element strides of the query-like and key-like tensors.
// Row strides are 32-bit (a row offset inside one head stays below 2^31
// elements; the varlen wrappers check it): with 64-bit ones the
// fixed-length forward spills registers at head_dim 64.
struct Layout {
  int sq, sk;
  int q_rs, k_rs;
  long long q_hs, k_hs;
};

// Rows [row0, row0 + ROWS) of a [rows, D] io-typed matrix whose rows are
// `rs` elements apart into a float smem tile of stride D + 1; rows past the
// end read as 0.
template <typename T, int ROWS, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int row0,
                                          int rows, int rs) {
  constexpr int LD = D + 1;
  for (int idx = threadIdx.x; idx < ROWS * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const int gr = row0 + r;
    dst[r * LD + c] = gr < rows ? to_f(src[gr * rs + c]) : 0.f;
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

// The io type of a C entry's tensors: 0 float, 1 bf16 (the tensor-core
// kernels), 2 fp16.
enum Io : int { IO_F32 = 0, IO_BF16 = 1, IO_F16 = 2 };

inline long long io_bytes(int io) { return io == IO_F32 ? 4 : 2; }

// A grid's y axis holds at most 65535 blocks, and the FMA kernels and the
// fixed-length bf16 kernels put the heads there. So every launch runs over
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

// Instantiates `body` for every io type T: float, bf16 or fp16 (the FMA
// kernels at head_dim 256 and above, which have no tensor-core
// instantiation yet); anything else is refused.
#define PT_FLASH_SWITCH_IO(io, ...)                          \
  switch (io) {                                              \
    case IO_F32: { using T = float; __VA_ARGS__; }           \
    case IO_BF16: { using T = __nv_bfloat16; __VA_ARGS__; }  \
    case IO_F16: { using T = __half; __VA_ARGS__; }          \
    default: return cudaErrorInvalidValue;                   \
  }

// Instantiates `body` for the FMA kernels' io type T: float or fp16 (bf16
// goes to the tensor-core kernels); anything else is refused.
#define PT_FLASH_SWITCH_FMA_IO(io, ...)                  \
  switch (io) {                                          \
    case IO_F32: { using T = float; __VA_ARGS__; }       \
    case IO_F16: { using T = __half; __VA_ARGS__; }      \
    default: return cudaErrorInvalidValue;               \
  }

// ------------------------------------------------ the tensor-core kernels
//
// Pieces shared by the bf16 kernels (`flash_fwd_hopper`,
// `flash_bwd_dq_hopper`, `flash_bwd_dkv_hopper`): 64-row bf16 tiles loaded
// by TMA and read with `wgmma` by one warpgroup of consumers.

constexpr int HOP_CONSUMERS = 128;  // one warpgroup
constexpr float LOG2E = 1.4426950408889634f;

// A 64-row bf16 tile of head_dim D in shared memory: BOXES boxes of W
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

// acc[64 x D] += A[64 x 16] (registers) * B[16 x D] (an MN-major tile).
template <int D>
__device__ __forceinline__ void wgmma_rs_d(float (&acc)[D / 2], const uint32_t (&a)[4],
                                           uint64_t db) {
  if constexpr (D == 32) pt_hopper::wgmma_rs_n32(acc, a, db);
  if constexpr (D == 64) pt_hopper::wgmma_rs_n64(acc, a, db);
  if constexpr (D == 128) pt_hopper::wgmma_rs_n128(acc, a, db);
}

// D = A B^T over D: the D / 16 products of one 64 x 64 tile, both operands
// K-major tiles; started, not committed or waited.
template <int D>
__device__ __forceinline__ void wgmma_nt(float (&d)[32], uint32_t a_addr, uint32_t b_addr) {
#pragma unroll
  for (int k = 0; k < D / 16; ++k)
    pt_hopper::wgmma_ss_n64(d, HopTile<D>::k_major(a_addr, k), HopTile<D>::k_major(b_addr, k),
                            k > 0);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x and y as bf16 pairs hi + lo: hi = bf16(x), lo = bf16(x - hi), so that
// hi + lo keeps 16 of x's bits (a relative error of about 2^-17) where hi
// alone keeps 8 (2^-9).
__device__ __forceinline__ void pack_bf16_split(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - __low2float(h), y - __high2float(h));
}

// Loads the BOXES boxes of one 64-row tile starting at `row` of head `h`;
// packed [T, H, D] maps are (D, H, T), fixed [BH, S, D] ones (D, S, BH).
template <int D>
__device__ __forceinline__ void tma_tile(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                         int row, int h, int packed) {
  using Tile = HopTile<D>;
#pragma unroll
  for (int b = 0; b < Tile::BOXES; ++b) {
    if (packed)
      pt_hopper::tma_load_3d(dst + b * Tile::BOX_BYTES, map, bar, b * Tile::W, h, row);
    else
      pt_hopper::tma_load_3d(dst + b * Tile::BOX_BYTES, map, bar, b * Tile::W, row, h);
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

// The tensor map of a q-like ([rows, D] per head) bf16 tensor: packed
// [rows, heads, D] as (D, heads, rows), fixed [heads, rows, D] as
// (D, rows, heads), with 64-row boxes of HopTile<D>::W columns.
template <int D>
int hop_map(CUtensorMap* map, const void* base, int rows, int heads, int rs, long long hs,
            int packed) {
  using Tile = HopTile<D>;
  const uint64_t dims[3] = {(uint64_t)D, (uint64_t)(packed ? heads : rows),
                            (uint64_t)(packed ? rows : heads)};
  const uint64_t strides[2] = {2ull * (packed ? hs : rs), 2ull * (packed ? rs : hs)};
  const uint32_t box[3] = {(uint32_t)Tile::W, packed ? 1u : 64u, packed ? 64u : 1u};
  return pt_hopper::encode_bf16_3d(map, base, dims, strides, box, Tile::SW);
}

}  // namespace pt_flash
