// Multi-head latent attention (MLA, DeepSeek-V2) for Hopper: decode and
// positioned-chunk attention of G q heads over one latent kv head, reading
// the latent cache in place.
//
// Replaces, at MLA's latent shapes, the Pallas TPU kernels
// repro/kernels/decode_attention.py::decode_attention (:88),
// ::decode_attention_paged (:262), ::chunk_attention_paged (:373) and
// ::chunk_attention (:434), which the reference's mla_attention calls with
// k = [ckv | krope] (576 columns) and v = ckv zero-padded to 576.  The
// function here is that attention with v = ckv, 512 columns out (the
// columns the reference keeps): K row j of batch row b is [ckv[b, j] |
// krope[b, j]], V row j is ckv[b, j] (dense: ckv [B, S, 512], krope
// [B, S, 64]; paged: arenas [P, ps, 512] and [P, ps, 64] through one block
// table bt [B, NB], S = NB * ps).  Query rows of a chunk are (t, g): query
// t of row b attends columns <= pos[b] + t (clamped to S - 1); decode is
// the one-token chunk at offset kv_len[b] - 1.
//
// What bounds it on an H100.  Bytes at decode: a 1152-byte latent row
// feeds G = 16 q heads, 2 * 16 * (576 + 512) FLOPs, ~30 FLOPs a byte, far
// below the ~295 where the card stops being memory-bound.  Operations for
// a 512-token chunk: a latent row feeds up to 8192 query rows.
//
// bf16 design (latent_kernel).  A block of 12 warps takes 64 query rows of
// one batch row against one range of columns: two consumer warpgroups and
// a producer warpgroup, of which one warp loads.  The producer gives its
// registers to the consumers (setmaxnreg: 40 and 232 a thread; at 168, the
// launch's share of 384 threads, the consumers spilled and ptxas
// serialized their wgmma).
// - The K tile is the V tile.  A ring stage holds 64 cache rows as nine
//   64-column panels in the swizzled layout of attn_tc.cuh, panels 0-7 from
//   ckv through one TMA map and panel 8 from krope through a second.
//   S = Q K^T reads all nine K-major; O += P V reads panels 0-7 of the same
//   stage MN-major.  One load serves both products: 1152 bytes a key, not
//   the 2304 of a K row and a zero-padded V row, and no product over the
//   64 zero columns.
// - The producer warp keeps both stages loading, on mbarrier full / empty
//   pairs, so loads overlap the block's own products: a stage is refilled
//   as soon as both warpgroups' P V has read it.
// - wgmma for both products.  The Q tile (64 x 576, 73.7 KB) stays in
//   shared memory.  Warpgroup 0 forms S for the tile's 64 keys (m64n64k16
//   over 36 k-steps) and runs each row's online softmax once, in log2
//   units with the scale applied to S in f32; it writes P, rounded to
//   bf16, and the rows' rescales to shared memory and signals warpgroup 1
//   on a named barrier.  Each warpgroup multiplies P into its 256 of the
//   512 output columns (m64n256k16): 128 f32 accumulators a thread.
//   Warpgroup 1 signals back when its P V is done, so warpgroup 0 forms
//   the next tile's S while warpgroup 1 multiplies the last one.  (Each
//   warpgroup forming S for 32 of the keys, their row maxima exchanged,
//   read Q's operand twice per tile: 216 KB of shared-memory reads for S
//   against 144.)
// - Shared memory: Q 73,728 + ring 2 x 73,728 + P 8,192 + the rows'
//   rescales and sums 512 + barriers, from a 1024-byte boundary: 230,948
//   of the 232,448 bytes a block may have.  So one block an SM and two
//   stages (a third does not fit); the Q tile's 73.7 KB had to stay, since
//   every tile's S reads all of it.
// - Copy routes.  TMA from [B, S, 512] / [B, S, 64] maps (dense; rows past
//   S arrive as zeros) or from [P, ps, 512] / [P, ps, 64] maps (paged at
//   page sizes that are multiples of 64, the serving pool's: a 64-row tile
//   lies in one page, whose id the producer reads from the table).  Any
//   other page size: the producer warp gathers 16-byte chunks by cp.async
//   into the same layout (rows past the block's columns zero-filled),
//   waits for them and releases the stage.
// - Decode (the G q heads of one token) runs the same body: its G <= 64
//   rows are padded to the 64 a wgmma takes (zero Q rows, never stored).
//   The products are then four times the need.  That costs little while
//   decode is bound by bytes and by its fixed costs: on the card a block's
//   second tile, its padded products included, added ~1.3 us to a launch
//   that takes ~9 us with no tile at all (chip_ab.py phase mla).  So one
//   body and one layout, where mma.sync m16 would need a second body.
// Split plan (decode_attention.py::decode_splits, chunk_splits): columns
// cut into ranges of whole 64-row tiles by S, or by (G, T, S), alone; one
// block a range.  The last block of a query tile to finish (one atomic)
// merges the ranges' f32 (acc, m, l) in range order and resets its counter,
// so the counters are 0 after every launch.  A row with kv_len == 0 gives
// zeros (m -1e30, l 0).  All routes run one arithmetic body and a masked
// entry adds exactly 0 (a select), so paged output equals dense output on
// the same cache, and a row's output does not depend on the rows beside
// it.  Whole tiles or pages are read: cache rows past a row's limit must be
// finite (caches start at zero).  Numerics: bf16 enters at the operands, at
// P (rounded before P V; l sums the unrounded p) and at the output; m, l,
// the partials and the merge are f32.
//
// f32 keeps an FMA body (latent_fma_kernel: 256 threads, 32 query rows
// against 16-row tiles, a 2 x 1 register tile of S and 2 x 32 of O, V the
// first 512 columns of the K tile, no split; decode is its one-token chunk
// and writes the residuals): a TF32 product would break the f32 tests' 2e-5.
#include "attn_tc.cuh"
#include "common.cuh"
#include "mma.cuh"

namespace {

using rt::kNegInf;
using tc::bf16;

constexpr int kDK = 576;          // K width: the latent 512 and the rope 64
constexpr int kDV = 512;          // V and output width: the latent
constexpr int kDR = kDK - kDV;
constexpr int kM = 64;            // query rows a block
constexpr int kBN = 64;           // cache rows a tile
constexpr int kPanels = kDK / 64;
constexpr int kConsumers = 256;   // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
// Registers a thread after the rebalance (the launch gives each of the 384
// threads 168): the producer warpgroup keeps 40, the consumers take 232
// (40 x 128 + 232 x 256 = 64,512 of the SM's 65,536)
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kStage = kBN * kDK;           // elements of a ring stage
constexpr float kLn2 = 0.6931471805599453f;

// How a block's cache tiles reach shared memory.
enum Route : int {
  kDense = 0,      // TMA from [B, S, 512] / [B, S, 64] maps
  kPagedTma = 1,   // TMA from [P, ps, 512] / [P, ps, 64] maps; ps a multiple of kBN
  kGather = 2,     // paged, any other page size: cp.async 16-byte chunks
};

// What the kernels need to know about the problem.  Decode is the chunk
// of one token (T = 1) whose rows see [0, kv_len): `lens` holds kv_len and
// the row's offset is kv_len - 1.
struct LatentProblem {
  int G, T;
  int S;            // the row's length: dense S, or nb * ps
  int nb, ps;       // paged: block-table width and page size
  int split_cols;   // columns per split range, a multiple of kBN
  float mul;        // bf16: scale * log2(e), scores in log2 units; f32: scale
  int decode;       // 1: lens are kv_len (T = 1)
  __device__ int rows() const { return G * T; }
  __device__ int offset(int len) const { return decode ? min(max(len, 0), S) - 1 : len; }
  // the last column tile row r = (t, g) sees at offset p0 (-1: none)
  __device__ int limit(int p0, int r) const {
    if (r >= rows()) return -1;
    const int lim = p0 + r / G;
    return lim < S - 1 ? lim : S - 1;
  }
};

// Byte offsets of the bf16 kernel's shared memory from its 1024-byte
// boundary.
struct Smem {
  static constexpr size_t kQ = 0;                                   // [64, 576] Q
  static constexpr size_t kRing = kQ + kM * kDK * sizeof(bf16);     // 2 stages
  static constexpr size_t kP = kRing + 2 * kStage * sizeof(bf16);   // [64, 64] P
  static constexpr size_t kRed = kP + kM * kBN * sizeof(bf16);      // 2 x [64] f32
  static constexpr size_t kBars = kRed + 2 * kM * sizeof(float);    // full[2], empty[2]
  static constexpr size_t kLast = kBars + 4 * sizeof(uint64_t);     // the merge flag
  static constexpr size_t kBytes = kLast + sizeof(int) + tc::kAlign;
};
static_assert(Smem::kBytes <= 232448, "the bf16 kernel's shared memory");

// Named barriers of the consumer warpgroups (the producer never joins;
// 0 is __syncthreads): all consumers; P ready, P free (warpgroup 0 and
// warpgroup 1, one arriving, the other waiting); warpgroup 0 alone.
enum Bar : int { kAll = 1, kPReady = 2, kPFree = 3, kWg0 = 4 };

__device__ __forceinline__ void named_sync(int id, int threads = kConsumers) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads = kConsumers) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void consumers_sync() { named_sync(kAll); }

// Descriptor of V for one k-step of P V: rows [16 ks, 16 ks + 16) of a
// stage, the 256 columns from panel `panel` (MN-major: the next 64
// columns one panel on, the next 8 rows 1024 bytes on).
__device__ __forceinline__ uint64_t vdesc(const bf16* st, int ks, int panel) {
  return mma::make_desc(st + panel * kBN * 64 + ks * 16 * 64, kBN * 64 * sizeof(bf16),
                        8 * 64 * sizeof(bf16), 1);
}

// One block: 64 query rows (tile blockIdx.y from the last) of batch row
// blockIdx.x, columns of split range blockIdx.z (see the head note).
template <int kRoute>
__global__ void __launch_bounds__(kThreads, 1)
latent_kernel(const bf16* __restrict__ q, const __grid_constant__ CUtensorMap tmc,
              const __grid_constant__ CUtensorMap tmr, const bf16* __restrict__ ckv,
              const bf16* __restrict__ krope, const int* __restrict__ bt,
              const int* __restrict__ lens, bf16* __restrict__ o, float* __restrict__ m_out,
              float* __restrict__ l_out, float* __restrict__ part, int* __restrict__ done,
              LatentProblem pb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = tc::aligned_smem(smem_raw);
  bf16* q_s = reinterpret_cast<bf16*>(base + Smem::kQ);
  bf16* ring = reinterpret_cast<bf16*>(base + Smem::kRing);
  bf16* p_s = reinterpret_cast<bf16*>(base + Smem::kP);
  float* red = reinterpret_cast<float*>(base + Smem::kRed);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + Smem::kBars);
  uint64_t* empty = full + 2;
  int* last = reinterpret_cast<int*>(base + Smem::kLast);

  const int b = blockIdx.x;
  const int tile = gridDim.y - 1 - blockIdx.y;           // longest tiles first
  const int r0 = tile * kM;
  const int nrows = min(pb.rows() - r0, kM);
  const int p0 = pb.offset(lens[b]);
  const int ncols = pb.limit(p0, r0 + nrows - 1) + 1;   // columns any row sees
  const int active = max((ncols + pb.split_cols - 1) / pb.split_cols, 1);   // live ranges
  if (static_cast<int>(blockIdx.z) >= active) return;
  const int lo = blockIdx.z * pb.split_cols;             // this block's columns [lo, hi)
  const int hi = min(ncols, lo + pb.split_cols);
  const int ntiles = max((hi - lo + kBN - 1) / kBN, 0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  auto q_of = [&](int rr) {   // q / o row of tile row rr = (t, g)
    const int r = r0 + rr;
    return (static_cast<size_t>(b) * pb.G + r % pb.G) * pb.T + r / pb.G;
  };

  // producer warp: start loading tile j into stage j % 2 (j >= 2: once
  // both warpgroups are done with tile j - 2)
  auto load = [&](int j) {
    const int row0 = lo + j * kBN;
    bf16* st = ring + (j & 1) * kStage;
    uint64_t* bar = full + (j & 1);
    if constexpr (kRoute == kGather) {
      // the arena row of this lane's two tile rows (-1 past hi: zeros)
      long long own[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int col = row0 + lane + 32 * i;
        own[i] = col < hi ? static_cast<long long>(bt[static_cast<size_t>(b) * pb.nb +
                                                      col / pb.ps]) * pb.ps + col % pb.ps
                          : -1;
      }
      if (j >= 2) mma::mbar_wait(empty + (j & 1), ((j >> 1) - 1) & 1);
      for (int r = 0; r < kBN; ++r) {
        const long long row = __shfl_sync(0xffffffffu, r < 32 ? own[0] : own[1], r & 31);
        const bool ok = row >= 0;
        for (int c = lane; c < kDK / 8; c += 32) {
          const bf16* src = !ok              ? ckv
                            : c < kDV / 8    ? ckv + row * kDV + c * 8
                                             : krope + row * kDR + (c - kDV / 8) * 8;
          mma::cp_async16(st + tc::tile_off<kDK, kBN>(r, c), src, ok);
        }
      }
      mma::cp_async_commit();
      mma::cp_async_wait<0>();
      mma::fence_async_smem();   // this lane's chunks, to the products' proxy
      mma::mbar_arrive(bar);
    } else if (lane == 0) {
      int z = b, y = row0;   // the map's (outer, row) of the tile
      if constexpr (kRoute == kPagedTma) {
        z = bt[static_cast<size_t>(b) * pb.nb + row0 / pb.ps];
        y = row0 % pb.ps;
      }
      if (j >= 2) mma::mbar_wait(empty + (j & 1), ((j >> 1) - 1) & 1);
      mma::mbar_expect_tx(bar, kStage * sizeof(bf16));
#pragma unroll
      for (int p = 0; p < kPanels - 1; ++p)
        mma::tma_load_3d(st + p * kBN * 64, &tmc, p * 64, y, z, bar);
      mma::tma_load_3d(st + (kPanels - 1) * kBN * 64, &tmr, 0, y, z, bar);
    }
  };

  if (warp == kConsumers / 32) {   // set the barriers, load the first two tiles
    if (lane == 0) {
      for (int i = 0; i < 2; ++i) {
        mma::mbar_init(full + i, kRoute == kGather ? 32 : 1);
        mma::mbar_init(empty + i, kConsumers / 32);   // one arrival a consumer warp
      }
      mma::mbar_init_fence();
    }
    __syncwarp();
    for (int j = 0; j < min(ntiles, 2); ++j) load(j);
  } else if (threadIdx.x < kConsumers) {   // Q, while they load
    tc::load_rows<kDK, kM, kConsumers>(q_s, q, nrows, q_of);
    mma::cp_async_commit();
    mma::cp_async_wait<0>();
    mma::fence_async_smem();
  }
  __syncthreads();   // the barriers are set, Q has landed

  if (threadIdx.x >= kConsumers) {   // the producer warpgroup: one warp loads
    mma::setmaxnreg_dec<kProducerRegs>();
    if (warp != kConsumers / 32) return;
    for (int j = 2; j < ntiles; ++j) load(j);
    return;
  }

  // The consumers.  Both warpgroups hold all 64 rows (warp wi: rows rw
  // and rw + 8).  Warpgroup 0 forms S = Q K^T of the whole tile and runs
  // the online softmax; it hands P (bf16) and each row's rescale to
  // warpgroup 1 through shared memory.  Each warpgroup multiplies P into
  // its 256 of the 512 output columns.  Named barriers: kPReady (warpgroup
  // 0 arrives once a tile's P and rescales are written; warpgroup 1 waits)
  // and kPFree (warpgroup 1 arrives once its P V of the tile is done;
  // warpgroup 0 waits before it writes the next P), so warpgroup 0's S of
  // tile j + 1 runs while warpgroup 1 multiplies tile j.
  mma::setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp >> 2, wi = warp & 3, g = lane >> 2, qd = lane & 3;
  const int rw = wi * 16 + g;
  const int lim[2] = {pb.limit(p0, r0 + rw), pb.limit(p0, r0 + rw + 8)};
  // the tile's first row sees the fewest columns; rows past the last
  // valid one may go unmasked: their zero Q gives finite p, never stored
  const int lim_lo = pb.limit(p0, r0);
  float* row_scale = red;        // [kM] the tile's rescale of each row
  float* row_sum = red + kM;     // [kM] the rows' sums, at the end
  auto score = [&](float& x) { x *= pb.mul; };   // scores to log2 units
  float acc[32][4] = {};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // warpgroup 0's; m in log2 units

  for (int j = 0; j < ntiles; ++j) {
    const bf16* st = ring + (j & 1) * kStage;
    float alpha[2];
    if (wg == 0) {
      mma::mbar_wait(full + (j & 1), (j >> 1) & 1);
      float s[8][4] = {};
      mma::fence_regs(s);
      mma::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDK / 16; ++kk)   // S = Q K^T over the tile's 64 keys
        mma::wgmma_ss_n64<0>(s, tc::kdesc<kDK, kM>(q_s, 0, kk), tc::kdesc<kDK, kBN>(st, 0, kk));
      mma::wgmma_commit();
      mma::wgmma_wait<0>();
      mma::fence_regs(s);
      const int c0 = lo + j * kBN;
      if (c0 + kBN - 1 <= lim_lo)   // every row sees the whole tile
        tc::online_softmax<false>(s, m, l, alpha, c0 + 2 * qd, lim, score);
      else
        tc::online_softmax<true>(s, m, l, alpha, c0 + 2 * qd, lim, score);
      if (j > 0) named_sync(kPFree);   // warpgroup 1 is done with the last P
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<__nv_bfloat162*>(p_s + tc::tile_off<64, kM>(rw + 8 * h, n) +
                                             2 * qd) =
              __floats2bfloat162_rn(s[n][2 * h], s[n][2 * h + 1]);
      if (qd == 0) {
        row_scale[rw] = alpha[0];
        row_scale[rw + 8] = alpha[1];
      }
      mma::fence_async_smem();   // this thread's P, to the products' proxy
      named_sync(kWg0, 128);     // all of warpgroup 0's P, for its own P V
      named_arrive(kPReady);
    } else {
      named_sync(kPReady);
      mma::mbar_wait(full + (j & 1), (j >> 1) & 1);   // this warpgroup's view of the stage
      alpha[0] = row_scale[rw];
      alpha[1] = row_scale[rw + 8];
    }
#pragma unroll
    for (int n = 0; n < 32; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    mma::fence_regs(acc);
    mma::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBN / 16; ++ks)   // O += P V, this warpgroup's 256 columns
      mma::wgmma_ss_n256_tb(acc, tc::kdesc<64, kM>(p_s, 0, ks), vdesc(st, ks, 4 * wg));
    mma::wgmma_commit();
    mma::wgmma_wait<0>();
    mma::fence_regs(acc);
    if (lane == 0) mma::mbar_arrive(empty + (j & 1));   // this warp is done with the stage
    if (wg == 1 && j + 1 < ntiles) named_arrive(kPFree);
  }

  // l: warpgroup 0's quad sums, handed to warpgroup 1
  float lt[2];
  if (wg == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
    if (qd == 0) {
      row_sum[rw] = l[0];
      row_sum[rw + 8] = l[1];
    }
  }
  consumers_sync();
  lt[0] = row_sum[rw];
  lt[1] = row_sum[rw + 8];

  if (active == 1) {   // the tile's only range: normalize and store
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rw + 8 * i;
      if (r >= nrows) continue;
      const float inv = lt[i] == 0.f ? 0.f : 1.f / lt[i];
      bf16* orow = o + q_of(r) * kDV + 256 * wg + 2 * qd;
#pragma unroll
      for (int n = 0; n < 32; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
            __floats2bfloat162_rn(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
      if (m_out != nullptr && wg == 0 && qd == 0) {
        m_out[q_of(r)] = lt[i] == 0.f ? kNegInf : m[i] * kLn2;
        l_out[q_of(r)] = lt[i];
      }
    }
    return;
  }

  // Split: publish this range's (acc, m, l) rows; the last of the tile's
  // live ranges to arrive merges them all, in range order.  part holds
  // every block's [64, 512] accumulators, then every block's [64, 2] (m, l).
  const size_t first = (static_cast<size_t>(b) * gridDim.y + tile) * gridDim.z;   // range 0
  float* pml = part + static_cast<size_t>(gridDim.x) * gridDim.y * gridDim.z * kM * kDV;
  {
    const size_t slot = first + blockIdx.z;
    float* pacc = part + slot * kM * kDV;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rw + 8 * i;
      if (r >= nrows) continue;
#pragma unroll
      for (int n = 0; n < 32; ++n)
        *reinterpret_cast<float2*>(pacc + r * kDV + 256 * wg + 8 * n + 2 * qd) =
            make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
      if (wg == 0 && qd == 0)
        *reinterpret_cast<float2*>(pml + (slot * kM + r) * 2) = make_float2(m[i], lt[i]);
    }
  }
  __threadfence();
  consumers_sync();
  const size_t ctr = static_cast<size_t>(b) * gridDim.y + tile;
  if (threadIdx.x == 0) *last = atomicAdd(done + ctr, 1) == active - 1;
  consumers_sync();
  if (!*last) return;
  if (threadIdx.x == 0) done[ctr] = 0;   // every counter is 0 again for the next launch
  __threadfence();
  // each range's weight for each row, exp2(m - m*) / l*, into the ring
  // (every tile has been read); then the rows, eight columns a thread,
  // kU ranges' loads in flight at once
  float* w_s = reinterpret_cast<float*>(ring);   // [active][kM]
  auto ml_of = [&](int sp, int r) {   // range sp's (m, l) of row r
    return __ldcg(reinterpret_cast<const float2*>(pml + ((first + sp) * kM + r) * 2));
  };
  for (int r = threadIdx.x; r < nrows; r += kConsumers) {
    float mx = kNegInf;
    for (int sp = 0; sp < active; ++sp) mx = fmaxf(mx, ml_of(sp, r).x);
    float sum = 0.f;
    for (int sp = 0; sp < active; ++sp) {
      const float2 ml = ml_of(sp, r);
      sum += exp2f(ml.x - mx) * ml.y;
    }
    const float inv = sum == 0.f ? 0.f : 1.f / sum;
    for (int sp = 0; sp < active; ++sp) w_s[sp * kM + r] = exp2f(ml_of(sp, r).x - mx) * inv;
    if (m_out != nullptr) {
      m_out[q_of(r)] = sum == 0.f ? kNegInf : mx * kLn2;
      l_out[q_of(r)] = sum;
    }
  }
  consumers_sync();
  constexpr int kU = 8;
  for (int i = threadIdx.x; i < nrows * (kDV / 8); i += kConsumers) {
    const int r = i / (kDV / 8), c = (i % (kDV / 8)) * 8;
    float a[8] = {};
    for (int sp0 = 0; sp0 < active; sp0 += kU) {
      float4 x[kU][2];
      float w[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int sp = sp0 + u;
        const bool ok = sp < active;
        const float4* src =
            reinterpret_cast<const float4*>(part + ((first + (ok ? sp : 0)) * kM + r) * kDV + c);
        x[u][0] = ok ? __ldcg(src) : make_float4(0.f, 0.f, 0.f, 0.f);
        x[u][1] = ok ? __ldcg(src + 1) : make_float4(0.f, 0.f, 0.f, 0.f);
        w[u] = ok ? w_s[sp * kM + r] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        a[0] += w[u] * x[u][0].x;
        a[1] += w[u] * x[u][0].y;
        a[2] += w[u] * x[u][0].z;
        a[3] += w[u] * x[u][0].w;
        a[4] += w[u] * x[u][1].x;
        a[5] += w[u] * x[u][1].y;
        a[6] += w[u] * x[u][1].z;
        a[7] += w[u] * x[u][1].w;
      }
    }
    uint4 v;
    v.x = mma::pack_bf16(a[0], a[1]);
    v.y = mma::pack_bf16(a[2], a[3]);
    v.z = mma::pack_bf16(a[4], a[5]);
    v.w = mma::pack_bf16(a[6], a[7]);
    *reinterpret_cast<uint4*>(o + q_of(r) * kDV + c) = v;
  }
}

// ------------------------------------------------------------------ f32 ----
constexpr int kFThreads = 256;   // 16 x 16 threads: rows 2 ty, 2 ty + 1; column tx
constexpr int kFQ = 32;          // query rows a block
constexpr int kFK = 16;          // cache rows a tile
constexpr int kFP = kDK + 1;     // f32 row pitch (no bank conflicts)
constexpr int kFC = kDV / 16;    // a thread's output columns: tx + 16 c

constexpr size_t fma_smem() {   // Q (pre-scaled), the K tile (V: its first 512), P
  return (kFQ * kFP + kFK * kFP + kFQ * (kFK + 1)) * sizeof(float);
}

// One block: 32 query rows (tile blockIdx.x) of batch row blockIdx.y
// against all the columns they see (see the head note).
template <bool kPaged>
__global__ void __launch_bounds__(kFThreads)
latent_fma_kernel(const float* __restrict__ q, const float* __restrict__ ckv,
                  const float* __restrict__ krope, const int* __restrict__ bt,
                  const int* __restrict__ lens, float* __restrict__ o, float* __restrict__ m_out,
                  float* __restrict__ l_out, LatentProblem pb) {
  extern __shared__ float fsm[];
  float* q_s = fsm;                 // [kFQ][kFP]
  float* k_s = q_s + kFQ * kFP;     // [kFK][kFP]
  float* p_s = k_s + kFK * kFP;     // [kFQ][kFK + 1]
  const int b = blockIdx.y, tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int r0 = blockIdx.x * kFQ;
  const int rows = pb.rows();
  const int p0 = pb.offset(lens[b]);
  auto q_of = [&](int rr) {
    const int r = r0 + rr;
    return (static_cast<size_t>(b) * pb.G + r % pb.G) * pb.T + r / pb.G;
  };
  for (int i = tid; i < kFQ * (kDK / 4); i += kFThreads) {
    const int rr = i / (kDK / 4), c = (i % (kDK / 4)) * 4;
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + rr < rows) t = *reinterpret_cast<const float4*>(q + q_of(rr) * kDK + c);
    float* d = q_s + rr * kFP + c;
    d[0] = t.x * pb.mul;
    d[1] = t.y * pb.mul;
    d[2] = t.z * pb.mul;
    d[3] = t.w * pb.mul;
  }
  const int ncols = pb.limit(p0, min(r0 + kFQ, rows) - 1) + 1;   // columns any row sees
  float m_i[2], l_i[2], acc[2][kFC];
  int lim[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lim[i] = pb.limit(p0, r0 + ty * 2 + i);
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kFC; ++c) acc[i][c] = 0.f;
  }
  __syncthreads();

  for (int c0 = 0; c0 < ncols; c0 += kFK) {
    for (int i = tid; i < kFK * (kDK / 4); i += kFThreads) {
      const int jj = i / (kDK / 4), c = (i % (kDK / 4)) * 4, col = c0 + jj;
      float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
      if (col < ncols) {
        const long long row =
            kPaged ? static_cast<long long>(bt[static_cast<size_t>(b) * pb.nb + col / pb.ps]) *
                             pb.ps + col % pb.ps
                   : static_cast<long long>(b) * pb.S + col;
        t = c < kDV ? *reinterpret_cast<const float4*>(ckv + row * kDV + c)
                    : *reinterpret_cast<const float4*>(krope + row * kDR + c - kDV);
      }
      float* d = k_s + jj * kFP + c;
      d[0] = t.x;
      d[1] = t.y;
      d[2] = t.z;
      d[3] = t.w;
    }
    __syncthreads();

    float s[2] = {0.f, 0.f};
#pragma unroll 8
    for (int d = 0; d < kDK; ++d) {
      const float kv = k_s[tx * kFP + d];
#pragma unroll
      for (int i = 0; i < 2; ++i) s[i] += q_s[(ty * 2 + i) * kFP + d] * kv;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int col = c0 + tx;
      const bool ok = col <= lim[i] && col < ncols;
      float mx = ok ? s[i] : kNegInf;
      // reduce over the 16 threads (tx) that share this row
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      const float p = ok ? expf(s[i] - m_new) : 0.f;
      p_s[(ty * 2 + i) * (kFK + 1) + tx] = p;
      float rs = p;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_i[i] = alpha * l_i[i] + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < kFC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kFK; ++j) {   // O += P V, V the tile's first 512 columns
      float vv[kFC];
#pragma unroll
      for (int c = 0; c < kFC; ++c) vv[c] = k_s[j * kFP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float p = p_s[(ty * 2 + i) * (kFK + 1) + j];
#pragma unroll
        for (int c = 0; c < kFC; ++c) acc[i][c] += p * vv[c];
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rr = ty * 2 + i;
    if (r0 + rr >= rows) continue;
    float* orow = o + q_of(rr) * kDV;
    const float l = l_i[i];
#pragma unroll
    for (int c = 0; c < kFC; ++c) orow[tx + 16 * c] = l == 0.f ? 0.f : acc[i][c] / l;
    if (m_out != nullptr && tx == 0) {
      m_out[q_of(rr)] = m_i[i];
      l_out[q_of(rr)] = l;
    }
  }
}

// ----------------------------------------------------------------- host ----
// What a launch takes besides its tensors: decode is the one-token chunk
// (T = 1) whose lens are kv_len; pages: the arena's page count (paged).
struct LatentArgs {
  int B, G, T, nsplit, split_cols, pages;
  float scale;
  bool decode;
};

// TMA maps of the latent cache, [outer, rows, 512] and [outer, rows, 64]
// bf16: a box is one 64-column panel of kBN rows, 128-byte swizzle; rows
// past `rows` load as zeros.
cudaError_t latent_maps(CUtensorMap* tmc, CUtensorMap* tmr, const void* ckv, const void* krope,
                        int rows, int outer) {
  const tc::EncodeTiled encode = tc::tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  auto one = [&](CUtensorMap* map, const void* base, int cols) {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                                static_cast<cuuint64_t>(outer)};
    const cuuint64_t strides[2] = {cols * sizeof(bf16),
                                   static_cast<cuuint64_t>(rows) * cols * sizeof(bf16)};
    const cuuint32_t box[3] = {64, kBN, 1}, unit[3] = {1, 1, 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                  strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  };
  return one(tmc, ckv, kDV) && one(tmr, krope, kDR) ? cudaSuccess : cudaErrorInvalidValue;
}

// bf16: the tensor-core kernel.  Grid: batch rows x tiles of 64 query rows
// x split ranges.
template <int kRoute>
cudaError_t latent_bf16(const void* q, const void* ckv, const void* krope, const int* bt, int nb,
                        int ps, const int* lens, void* o, float* m, float* l, float* part,
                        int* done, const LatentArgs& a, cudaStream_t s) {
  CUtensorMap tmc{}, tmr{};
  cudaError_t err = cudaSuccess;
  if constexpr (kRoute == kDense)   // ps is S
    err = latent_maps(&tmc, &tmr, ckv, krope, ps, a.B);
  else if constexpr (kRoute == kPagedTma)
    err = latent_maps(&tmc, &tmr, ckv, krope, ps, a.pages);
  if (err != cudaSuccess) return err;
  const LatentProblem pb{a.G, a.T, nb * ps, nb, ps, a.split_cols, a.scale * tc::kLog2e,
                         a.decode ? 1 : 0};
  auto kernel = latent_kernel<kRoute>;
  static const cudaError_t attr = rt::set_smem(kernel, Smem::kBytes);   // once per process
  if (attr != cudaSuccess) return attr;
  const int tiles = (a.G * a.T + kM - 1) / kM;
  kernel<<<dim3(a.B, tiles, a.nsplit), kThreads, Smem::kBytes, s>>>(
      static_cast<const bf16*>(q), tmc, tmr, static_cast<const bf16*>(ckv),
      static_cast<const bf16*>(krope), bt, lens, static_cast<bf16*>(o), m, l, part, done, pb);
  return cudaGetLastError();
}

// f32: the FMA kernel (no split).  Grid: tiles of 32 query rows x batch rows.
template <bool kPaged>
cudaError_t latent_f32(const void* q, const void* ckv, const void* krope, const int* bt, int nb,
                       int ps, const int* lens, void* o, float* m, float* l, const LatentArgs& a,
                       cudaStream_t s) {
  if (a.nsplit != 1) return cudaErrorInvalidValue;
  const LatentProblem pb{a.G, a.T, nb * ps, nb, ps, 0, a.scale, a.decode ? 1 : 0};
  auto kernel = latent_fma_kernel<kPaged>;
  static const cudaError_t attr = rt::set_smem(kernel, fma_smem());   // once per process
  if (attr != cudaSuccess) return attr;
  const int tiles = (a.G * a.T + kFQ - 1) / kFQ;
  kernel<<<dim3(tiles, a.B), kFThreads, fma_smem(), s>>>(
      static_cast<const float*>(q), static_cast<const float*>(ckv),
      static_cast<const float*>(krope), bt, lens, static_cast<float*>(o), m, l, pb);
  return cudaGetLastError();
}

// One launch of either kernel: bt null is the dense cache (nb = 1, ps = S).
int latent_common(const void* q, const void* ckv, const void* krope, const void* bt, int nb,
                  int ps, const void* lens, void* o, void* m, void* l, void* part, void* done,
                  const LatentArgs& a, int dtype, void* stream) {
  if (a.B <= 0 || a.G <= 0 || a.T <= 0) return cudaSuccess;
  // the ranges are whole tiles and cover the row's length S = nb * ps
  if (nb < 1 || ps < 1 || a.nsplit < 1 || a.nsplit > 64 || a.split_cols < kBN ||
      a.split_cols % kBN != 0 ||
      static_cast<long long>(a.nsplit) * a.split_cols < static_cast<long long>(nb) * ps ||
      (a.nsplit > 1 && (part == nullptr || done == nullptr)) || (a.decode && a.T != 1))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(bt);
  const int* ln = static_cast<const int*>(lens);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  float* pf = static_cast<float*>(part);
  int* dn = static_cast<int*>(done);
  switch (dtype) {
    case rt::kBF16:
      if (tb == nullptr)
        return latent_bf16<kDense>(q, ckv, krope, tb, nb, ps, ln, o, mf, lf, pf, dn, a, s);
      // a 64-row tile lies in one page when ps is a multiple of 64 (the
      // serving pool's); every other page size is gathered
      return ps % kBN == 0
                 ? latent_bf16<kPagedTma>(q, ckv, krope, tb, nb, ps, ln, o, mf, lf, pf, dn, a, s)
                 : latent_bf16<kGather>(q, ckv, krope, tb, nb, ps, ln, o, mf, lf, pf, dn, a, s);
    case rt::kF32:
      return tb == nullptr ? latent_f32<false>(q, ckv, krope, tb, nb, ps, ln, o, mf, lf, a, s)
                           : latent_f32<true>(q, ckv, krope, tb, nb, ps, ln, o, mf, lf, a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: [B, G, 576]; ckv: [B, S, 512]; krope: [B, S, 64]; kv_len: [B] int32;
// o: [B, G, 512]; m, l: [B, G] f32 or both null.  bf16 cuts S into `nsplit`
// ranges of `split_rows` rows (a multiple of 64, nsplit * split_rows >= S,
// nsplit <= 64), one block each; with nsplit > 1, `part` is f32 scratch of
// B*tiles*nsplit*64*514 values (tiles = ceil(G / 64)) and `done` B*tiles
// int32 counters, all 0 (every launch leaves them 0).  f32 takes nsplit = 1
// only.  Returns the launch's CUDA error.
extern "C" int mla_decode_attention_launch(const void* q, const void* ckv, const void* krope,
                                           const void* kv_len, void* o, void* m, void* l,
                                           void* part, void* done, int B, int G, int S,
                                           int nsplit, int split_rows, float scale, int dtype,
                                           void* stream) {
  return latent_common(q, ckv, krope, nullptr, 1, S, kv_len, o, m, l, part, done,
                       LatentArgs{B, G, 1, nsplit, split_rows, 0, scale, true}, dtype, stream);
}

// As mla_decode_attention_launch over two page arenas: ckv [P, ps, 512],
// krope [P, ps, 64]; bt: [B, nb] int32 page ids of both; the split ranges
// cut the virtual S = nb * ps.
extern "C" int mla_decode_attention_paged_launch(const void* q, const void* ckv,
                                                 const void* krope, const void* bt,
                                                 const void* kv_len, void* o, void* part,
                                                 void* done, int B, int G, int P, int nb, int ps,
                                                 int nsplit, int split_rows, float scale,
                                                 int dtype, void* stream) {
  if (bt == nullptr || P < 1) return cudaErrorInvalidValue;
  return latent_common(q, ckv, krope, bt, nb, ps, kv_len, o, nullptr, nullptr, part, done,
                       LatentArgs{B, G, 1, nsplit, split_rows, P, scale, true}, dtype, stream);
}

// q: [B, G, T, 576] at per-row offsets pos [B] int32; ckv: [B, S, 512];
// krope: [B, S, 64]; o: [B, G, T, 512].  bf16 cuts S into `nsplit` ranges
// of `split_cols` columns, as decode; `part` holds B*tiles*nsplit*64*514
// values (tiles = ceil(G*T / 64)) and `done` B*tiles counters.  f32 takes
// nsplit = 1 only.  Returns the launch's CUDA error.
extern "C" int mla_chunk_attention_launch(const void* q, const void* ckv, const void* krope,
                                          const void* pos, void* o, void* part, void* done,
                                          int B, int G, int T, int S, int nsplit,
                                          int split_cols, float scale, int dtype,
                                          void* stream) {
  return latent_common(q, ckv, krope, nullptr, 1, S, pos, o, nullptr, nullptr, part, done,
                       LatentArgs{B, G, T, nsplit, split_cols, 0, scale, false}, dtype, stream);
}

// As mla_chunk_attention_launch over two page arenas (as the paged decode).
extern "C" int mla_chunk_attention_paged_launch(const void* q, const void* ckv,
                                                const void* krope, const void* bt,
                                                const void* pos, void* o, void* part, void* done,
                                                int B, int G, int T, int P, int nb, int ps,
                                                int nsplit, int split_cols, float scale,
                                                int dtype, void* stream) {
  if (bt == nullptr || P < 1) return cudaErrorInvalidValue;
  return latent_common(q, ckv, krope, bt, nb, ps, pos, o, nullptr, nullptr, part, done,
                       LatentArgs{B, G, T, nsplit, split_cols, P, scale, false}, dtype, stream);
}
