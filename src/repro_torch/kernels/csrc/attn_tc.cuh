// Tensor-core pieces shared by the bf16 attention kernels
// (flash_attention.cu: forward, dK/dV, dQ; decode_attention.cu: chunk
// attention, dense and paged): swizzled shared-memory tiles, wgmma
// descriptors and product issue, the row gathers and stores, the TMA K/V
// ring, the online softmax in log2 units, and the TMA map encoder.
//
// Shared-memory tiles are [R, DT] bf16 in wgmma's canonical swizzled
// layout, each at a 1024-byte boundary.  DT is the tile width: the head
// dim, or 128 for head dim 80 (columns 80-127 are never read by a score
// product and never stored); 192 is three panels.  DT >= 64: panels of 64
// columns ([R, 64] each, 128-byte rows, 128-byte swizzle: 16-byte chunk c
// of row r at chunk c ^ (r % 8)); DT = 32: 64-byte rows, 64-byte swizzle
// (chunk c ^ (r / 2 % 4)).  The swizzle is what the hardware applies to the
// address, so the 8 rows a wgmma core matrix reads lie in 8 different bank
// groups; cp.async writes a tile with the same XOR and TMA with the same
// swizzle mode.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "mma.cuh"

namespace tc {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBN = 64;   // K/V rows per streamed tile

template <int D>
constexpr int kRowElems = D >= 64 ? 64 : D;            // elements in one swizzled row
template <int D>
constexpr uint32_t kSwizzle = D >= 64 ? 1 : 2;         // descriptor layout: 128B / 64B

// Tile width of head dim D: 80 runs on the 128-column layout.
template <int D>
__host__ __device__ constexpr int tile_dim() { return D == 80 ? 128 : D; }

// Element offset of 16-byte chunk c of row r.
template <int D, int R>
__device__ __forceinline__ int tile_off(int r, int c) {
  if (D >= 64) return (c >> 3) * R * 64 + r * 64 + (((c & 7) ^ (r & 7)) << 3);
  return r * D + ((c ^ ((r >> 1) & 3)) << 3);
}

// Descriptor of a K-major operand (the rows are M or N, D is K): the 64 or
// N rows from row r0 of an R-row tile, at k-step kk (16 columns).  Stride
// between 8-row groups: 8 swizzled rows; within a swizzle row a k-step
// moves the start by 32 bytes.
template <int D, int R>
__device__ __forceinline__ uint64_t kdesc(const bf16* tile, int r0, int kk) {
  constexpr int KPR = kRowElems<D> / 16;   // k-steps per swizzled row
  const bf16* p = tile + (kk / KPR) * R * kRowElems<D> + r0 * kRowElems<D> + (kk % KPR) * 16;
  return mma::make_desc(p, 16, 8 * kRowElems<D> * 2, kSwizzle<D>);
}

// Descriptor of an MN-major operand (the rows are K, D is N): the 16 rows
// of k-step kk of an R-row tile, columns of panel `panel` (64 wide, or all
// 32 at D = 32).  One wgmma reads one swizzle atom across N, so only the
// stride between 8-row groups (both offsets) is used.
template <int D, int R>
__device__ __forceinline__ uint64_t ndesc(const bf16* tile, int kk, int panel) {
  constexpr uint32_t group = 8 * kRowElems<D> * 2;
  return mma::make_desc(tile + panel * R * 64 + kk * 16 * kRowElems<D>, group, group,
                        kSwizzle<D>);
}

// Start copying R rows into a swizzled [R, D] tile (NT threads): tile row
// i < valid from src + row_of(i) * DS (DS <= D source columns, the rest of
// the tile row left as it is), the other rows zero-filled.
template <int D, int R, int NT, int DS = D, typename RowOf>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* __restrict__ src, int valid,
                                          RowOf row_of) {
  constexpr int C = DS / 8;
  constexpr bool kEven = (R * C) % NT == 0;   // else the last pass is partial
#pragma unroll
  for (int it = 0; it < (R * C + NT - 1) / NT; ++it) {
    const int i = it * NT + static_cast<int>(threadIdx.x), r = i / C, c = i % C;
    if (!kEven && i >= R * C) break;
    const bool ok = r < valid;
    mma::cp_async16(dst + tile_off<D, R>(r, c), ok ? src + row_of(r) * DS + c * 8 : src, ok);
  }
}

// Rows [r0, r0 + 16) of a swizzled tile -- one warp's -- to dst + row_of(i) * DS
// (the first DS columns), 16 bytes a lane; rows >= valid are skipped.
template <int D, int R, int DS = D, typename RowOf>
__device__ __forceinline__ void store_rows(const bf16* tile, bf16* __restrict__ dst, int r0,
                                           int valid, RowOf row_of) {
  constexpr int C = DS / 8;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int it = 0; it < 16 * C / 32; ++it) {
    const int i = it * 32 + lane, r = r0 + i / C, c = i % C;
    if (r < valid)
      *reinterpret_cast<uint4*>(dst + row_of(r) * DS + c * 8) =
          *reinterpret_cast<const uint4*>(tile + tile_off<D, R>(r, c));
  }
}

// A warp's 16 x D f32 accumulator (D layout), rows g times mul0 and g + 8
// times mul1, as bf16 into rows [r0, r0 + 16) of a swizzled tile.
template <int D, int R>
__device__ __forceinline__ void acc_to_tile(bf16* tile, int r0, const float (&acc)[D / 8][4],
                                            float mul0, float mul1) {
  const int lane = threadIdx.x & 31;
  const int r = r0 + (lane >> 2), cw = (lane & 3) * 2;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(tile + tile_off<D, R>(r, n) + cw) =
        __floats2bfloat162_rn(acc[n][0] * mul0, acc[n][1] * mul0);
    *reinterpret_cast<__nv_bfloat162*>(tile + tile_off<D, R>(r + 8, n) + cw) =
        __floats2bfloat162_rn(acc[n][2] * mul1, acc[n][3] * mul1);
  }
}

// Issue c += A B^T over the first KD columns for this warpgroup (64
// rows): A the rows [a0, a0 + 64) of tile a (RA rows), B the N rows of
// tile b (N = 8 NC: 64 or 32); c is the 64 x N D tile.  The caller
// fences, commits and waits.
template <int D, int RA, int KD = D, int NC>
__device__ __forceinline__ void issue_abt(float (&c)[NC][4], const bf16* a, int a0,
                                          const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < KD / 16; ++kk) {
    const uint64_t da = kdesc<D, RA>(a, a0, kk), db = kdesc<D, 8 * NC>(b, 0, kk);
    if constexpr (NC == 8)
      mma::wgmma_ss_n64<0>(c, da, db);
    else
      mma::wgmma_ss_n32<0>(c, da, db);
  }
}

// Issue c += P B for this warpgroup: P a 64 x 16KS bf16 A operand in
// registers, B the 16KS rows of tile b ([16KS, D], MN-major); c is 64 x D,
// one n64 product per 64-column panel (D 64, 128, 192) or one n32 (D 32).
template <int D, int KS>
__device__ __forceinline__ void issue_pb(float (&c)[D / 8][4], const uint32_t (&pa)[KS][4],
                                         const bf16* b) {
  static_assert(D == 32 || D == 64 || D == 128 || D == 192, "tile width");
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    if constexpr (D == 32) {
      mma::wgmma_rs_n32<0>(c, pa[ks], ndesc<D, 16 * KS>(b, ks, 0));
    } else {
      mma::wgmma_rs_n64<0>(c, pa[ks], ndesc<D, 16 * KS>(b, ks, 0));
      if constexpr (D >= 128) mma::wgmma_rs_n64<8>(c, pa[ks], ndesc<D, 16 * KS>(b, ks, 1));
      if constexpr (D >= 192) mma::wgmma_rs_n64<16>(c, pa[ks], ndesc<D, 16 * KS>(b, ks, 2));
    }
  }
}

// The block's dynamic shared memory from its first 1024-byte boundary (the
// launchers ask for kAlign bytes more).
constexpr size_t kAlign = 1024;
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((kAlign - (mma::smem_addr(raw) & (kAlign - 1))) & (kAlign - 1));
}

// Ring of NS K/V tile stages (two by default) of BN rows (kBN by
// default): stage j % NS holds K, then V, of tile j ([BN, D] and [BN, DV],
// DV = D by default, in the swizzled layout).  Filled by TMA, stage j % NS
// is complete when its mbarrier full[j % NS] completes its (j / NS)-th
// phase; rows past the tensor map's bounds arrive as zeros.  (A kernel
// that fills it by cp.async uses only the tiles.)
template <int D, int NS = 2, int BN = kBN, int DV = D>
struct KvRing {
  static constexpr int kStages = NS;
  static constexpr int kStageElems = BN * (D + DV);
  static constexpr size_t kStageBytes = kStageElems * sizeof(bf16);
  static constexpr size_t kBytes = NS * kStageBytes + NS * sizeof(uint64_t);
  bf16* tiles;
  uint64_t* full;
  __device__ explicit KvRing(void* at)
      : tiles(static_cast<bf16*>(at)),
        full(reinterpret_cast<uint64_t*>(tiles + NS * kStageElems)) {}
  __device__ bf16* k(int j) const { return tiles + (j % NS) * kStageElems; }
  __device__ bf16* v(int j) const { return k(j) + BN * D; }
  // One thread, before any use: the barriers (a block barrier must follow
  // before other threads wait).
  __device__ void init() const {
#pragma unroll
    for (int i = 0; i < NS; ++i) mma::mbar_init(full + i, 1);
    mma::mbar_init_fence();
  }
  // One thread: start loading tile j of kv head `head`, rows [row, row +
  // BN) of the map, one box per swizzled column panel.
  __device__ void load_at(const CUtensorMap* tk, const CUtensorMap* tv, int head, int j,
                          int row) const {
    uint64_t* bar = full + (j % NS);
    mma::mbar_expect_tx(bar, kStageBytes);
#pragma unroll
    for (int p = 0; p < D / kRowElems<D>; ++p)
      mma::tma_load_3d(k(j) + p * BN * 64, tk, p * 64, row, head, bar);
#pragma unroll
    for (int p = 0; p < DV / kRowElems<DV>; ++p)
      mma::tma_load_3d(v(j) + p * BN * 64, tv, p * 64, row, head, bar);
  }
  // Tile j = rows [j BN, (j + 1) BN).
  __device__ void load(const CUtensorMap* tk, const CUtensorMap* tv, int head, int j) const {
    load_at(tk, tv, head, j, j * BN);
  }
  __device__ void wait(int j) const { mma::mbar_wait(full + (j % NS), (j / NS) & 1); }
};

// One K/V tile of the online softmax, for this thread's two rows of a
// 16 x 8NS score tile (D layout): scores to log2 units by score(s) (in
// place); under kMask, the entries past each row's last visible column lim
// get p = 0; the running max m and sum l move on, s becomes p, and alpha is
// what the output accumulators are multiplied by.  cb: the column of entry
// (n = 0, e = 0).
template <bool kMask, int NS, typename ScoreFn>
__device__ __forceinline__ void online_softmax(float (&s)[NS][4], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], int cb, const int (&lim)[2],
                                               const ScoreFn& score) {
  float mx[2] = {rt::kNegInf, rt::kNegInf};
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      score(s[n][e]);
      if (!kMask || cb + n * 8 + (e & 1) <= lim[e >> 1]) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {   // the 4 lanes of a quad share a row
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float mn = fmaxf(m[i], mx[i]);
    alpha[i] = exp2f(m[i] - mn);
    m[i] = mn;
    l[i] *= alpha[i];
  }
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = !kMask || cb + n * 8 + (e & 1) <= lim[e >> 1];
      const float p = ok ? exp2f(s[n][e] - m[e >> 1]) : 0.f;
      s[n][e] = p;
      l[e >> 1] += p;
    }
}

// cuTensorMapEncodeTiled, fetched from the driver at run time (the
// libraries link only the runtime); null if the driver lacks it.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// TMA map of a [heads, rows, cols] bf16 tensor (cols <= D): a box is one
// swizzled column panel of a [BN, D] tile (BN rows, kBN by default), in
// the layout the kernels' wgmma descriptors and ldmatrix loads read; rows
// past `rows` and columns past `cols` load as zeros.
template <int D, int BN = kBN>
cudaError_t tile_map(CUtensorMap* map, const void* base, int heads, int rows, int cols = D) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {cols * sizeof(bf16),
                                 static_cast<cuuint64_t>(rows) * cols * sizeof(bf16)};
  const cuuint32_t box[3] = {kRowElems<D>, BN, 1}, unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      D >= 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// The TMA maps of k [heads, rows, cols] at tile width D and v [heads,
// rows, vcols] at tile width DV (see tile_map).
template <int D, int DV = D, int BN = kBN>
cudaError_t kv_maps(CUtensorMap* tk, CUtensorMap* tv, const void* k, const void* v, int heads,
                    int rows, int cols, int vcols) {
  const cudaError_t err = tile_map<D, BN>(tk, k, heads, rows, cols);
  return err != cudaSuccess ? err : tile_map<DV, BN>(tv, v, heads, rows, vcols);
}

}  // namespace tc
