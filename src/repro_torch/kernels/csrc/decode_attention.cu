// Flash-decode and positioned-chunk attention for Hopper.
//
// decode_attention replaces the Pallas TPU kernel
// repro/kernels/decode_attention.py::decode_attention (_decode_kernel):
// one query token per (row, q head) against a [S, D] KV cache row with a
// per-row valid length kv_len[b].  decode_attention_paged replaces
// ::decode_attention_paged (_decode_paged_kernel): the same body, templated
// on how a K/V row is addressed (dense, or a page arena through a block
// table, below).  Bound on an H100: bytes.  Every visible K/V row is read
// once and used for G q heads, about 2*G FLOPs per byte, far below the
// ~295 where the card stops being memory-bound; so what matters is keeping
// enough bytes in flight to approach 3.35 TB/s.
// bf16 design (namespace tc, decode_kernel).  A block of 4 warps takes the
// G q heads of one (row b, kv head), up to 16 of them (more G: one block
// per group of 16), against one range of S.  K/V tiles of 64 rows stay
// bf16 in shared memory, in a ring of 4 stages (3 at tile width 128: D 80
// and 128), filled by TMA on mbarriers (dense; paged at page sizes that
// are multiples of 64, one page per tile) or by a cp.async gather of
// 16-byte chunks (any other page size; rows past the range zero-filled),
// in the swizzled layout of attn_tc.cuh.  Every stage is loading from the
// block's start, and a stage is refilled as soon as the four warps are
// done with it: 64 KB (96 KB at width 128) in flight a block, with two or
// three blocks per SM.  Each warp owns 16 rows of every tile: S = Q K^T is
// mma.sync m16n8k16 with the q heads as the 16-row A operand (zero rows
// past G) and K read by ldmatrix; an f32 online softmax in log2 units,
// the scale applied to S in f32; O += P V with P rounded to bf16 (as the
// chunk kernel) and V read by ldmatrix.trans.  At the end the four warps'
// (acc, m, l) are merged in warp order through shared memory.
// Split plan: S is cut into ranges of whole tiles whose length depends on
// S only (decode_attention.py::decode_splits: 512 rows, longer past 64
// ranges; 512 ran faster on the card than 128-384 at both serving
// widths), never on B or kv_len, so a row's output does not depend on
// the rows that share its batch.  A block whose range starts past
// kv_len[b] exits at once.  A row with one live range writes its output
// directly; otherwise each range writes its f32 (acc, m, l) partial and
// the last to finish, counted with one atomic, merges them in range order
// (deterministic, one launch) and resets its counter to 0, so the counters
// are reused from launch to launch without a memset.  A row with
// kv_len == 0 writes zeros (and m = -1e30, l = 0), as the Pallas kernel
// does; the optional (m, l) residuals feed split-K merges.  All routes run
// one arithmetic body and a masked entry adds exactly 0 (a select), so the
// paged output equals the dense kernel's on the same K/V.
// f32 keeps the FMA body (decode_kernel below: 128 threads, f32 tiles
// with a D + 1 pitch, one table load per page before each tile) by an
// explicit dispatch on dtype: a TF32 product would break the f32 tests'
// 2e-5.  It takes the same split plan and also resets its counters.
//
// chunk_attention and chunk_attention_paged replace the Pallas TPU kernels
// repro/kernels/decode_attention.py::chunk_attention (_chunk_kernel) and
// ::chunk_attention_paged (_chunk_paged_kernel): a T-token chunk of
// queries per row at cache offset pos[b]; query t of row b attends columns
// <= pos[b] + t of K/V [B, Hkv, S, D] (dense) or of a page arena
// [P, Hkv, ps, D] through a block table bt [B, NB] (paged: K/V row j of
// (b, kv head h) is pages[bt[b, j / ps], h, j % ps, :], S = NB * ps).  No
// softcap, no lse.
// What bounds it on an H100.  Operations at prefill widths with G > 1: at
// T = 512, G = 8 a visible K/V row feeds G * T query rows, ~30 GFLOP for
// ~43 MB at the serving shape, far above the ~295 FLOP/byte where the card
// stops being memory-bound.  Bytes at G = 1 (zamba2's shared block, D 80)
// and at small T, where a K/V row feeds only G * T rows.
// bf16 design (namespace tc; the pieces shared with the flash forward are
// in attn_tc.cuh).  A block of 8 warps (two warpgroups) takes 128 query
// rows of one (row b, kv head) in (t, g) order, so the G q heads of a kv
// head share every K/V tile; a warpgroup with no rows skips its products.
// Two blocks per SM at every head dim: at D 80 and 128 the 128-register
// cap spills a few dozen bytes, yet at D 80 this ran faster on the card
// than one block per SM.
// S = Q K^T is a wgmma.mma_async m64n64k16 with both operands K-major in
// swizzled shared tiles; O += P V takes P rounded to bf16 as the register
// A operand and reads V MN-major.  The online softmax is f32 in log2
// units, the scale applied to S in f32 after the product.  Per-row causal
// offset: tile row r = (t, g) sees columns <= pos[b] + t, clamped to
// S - 1, so a row past S sees S columns.  A block streams K/V tiles of 64
// rows only up to the largest limit of its rows; only the tiles that some
// row does not see whole pay the mask compares, and a masked entry gets
// p = 0 by a select.  S needs no tile multiple.  Query tiles run longest
// first (the grid walks them from the last); pos is read on the device
// only, so the path has no host sync.
// Copy route.  Dense: K/V through a two-stage ring filled by TMA on
// mbarriers, from a [B*Hkv, S, D] tensor map (rows past S, and at D 80 the
// columns past 80, arrive as zeros).  Paged at page sizes that are
// multiples of 64 (the serving pool's 64): a 64-row tile lies in one page,
// so the same ring is filled by TMA from a [P*Hkv, ps, D] map, the tile's
// page read from the table one tile ahead.  Paged at any other page size:
// a cp.async gather of each 16-byte chunk from its page, written with the
// swizzle XOR of the query gather, two stages deep; each row's arena
// offset is staged in shared memory one tile ahead, under the S product,
// and rows past the block's last column are zero-filled (one TMA box per
// page was slower than this gather at page size 16).  Neither reads a
// table slot past a row's limit.  All routes run one arithmetic body and a
// masked entry adds exactly 0, so the paged output equals the dense
// kernel's on the same K/V.  Whole tiles or pages are read: cache rows
// past a row's limit must be finite (the Pallas kernel reads whole blocks
// too; caches start at zero).
// Split columns.  With few query tiles a row (T = 8, Hkv = 4, G = 8: 4
// blocks a row) the planner (decode_attention.py::chunk_splits) cuts S
// into `nsplit` ranges of whole 64-row tiles (flash-decoding, as
// decode_kernel), by a plan that follows (Hkv, G, T, S) alone: 8 ranges of
// 256 at that shape, so a group of 8 rows gives two blocks per SM.  A
// block whose range starts past its tile's last column exits at once.  A
// tile with one live range writes its output directly; otherwise each
// range writes its f32 (acc, m, l) partial and the last one to finish,
// counted by one atomic, merges them in range order (one launch,
// deterministic) and resets its counter.  The grid's B only places the
// partials: a row's output is the same alone and in any batch.
// D 80 (zamba2's shared block) runs on the 128-column tile layout: Q K^T
// skips the k-steps past column 80 (5 of 8 run), P V runs at n 128, and
// only 80 output columns are stored.
// Numerics: bf16 rounding enters at the operands (the inputs are bf16), at
// P before the P V product (unbiased, at most 2^-9 relative per entry;
// l sums the unrounded f32 p) and at the output; m, l, the partials and
// the merge are f32.
// f32 keeps the FMA body (256 threads as 16 x 16, a 4 x 4 register tile
// each for Q K^T and for P V, f32 tiles with a D + 1 pitch, 64 query rows
// per block, no split) by an explicit dispatch on dtype: a TF32 product
// would break the f32 tests' 2e-5.  A bf16 tensor always takes the tensor
// cores.
//
// Head dim 576 (MLA's latent attention) is not compiled here: it runs in
// mla_attention.cu, which reads the latent cache in place.
//
// Paged addressing, both kernels: a row stops at its own limit (kv_len,
// or pos + t) clamped to NB * ps, so it never reads a table slot past
// that limit, never touches scratch page 0 or an ungranted page unless its
// table points there, and gives such rows exactly zero softmax mass.
// Arena offsets are 64-bit.  A page id out of [0, P) is not checked on the
// device: the engine only writes ids it was granted.
#include "attn_tc.cuh"
#include "common.cuh"
#include "mma.cuh"

namespace {

using rt::kNegInf;

// Where K/V row j of one (batch row b, kv head h) lives.  Dense: rows of
// [B, Hkv, S, D] (nb = 1, ps = S, bt unused).  Paged: an arena
// [P, Hkv, ps, D] through the row's block table bt[b, :nb].  Either way
// the row's virtual length is S = nb * ps.
struct KvRows {
  const int* bt;
  int nb, ps;
};

constexpr int kMaxTilePages = 64;   // pages one 64-row tile can touch (ps = 1)

// Paged: the arena offsets of the pages that rows [j0, j1) of (b, h)
// touch, staged in `pbase` (one table load per page); returns the first
// page's slot.  The caller synchronizes before reading `pbase`.
template <int D>
__device__ __forceinline__ int stage_pages(const KvRows& kv, int b, int h, int hkv, int j0,
                                           int j1, long long* pbase) {
  const int pf = j0 / kv.ps, pl = (j1 - 1) / kv.ps;
  const int* row = kv.bt + static_cast<size_t>(b) * kv.nb;
  for (int i = threadIdx.x; i <= pl - pf; i += blockDim.x)
    pbase[i] = (static_cast<long long>(row[pf + i]) * hkv + h) * kv.ps * D;
  return pf;
}

// Element offset of K/V row j: from the staged page offsets (paged, pf the
// table slot of pbase[0]) or from the (row, head)'s dense row 0.
template <int D, bool kPaged>
__device__ __forceinline__ long long kv_offset(const KvRows& kv, const long long* pbase, int pf,
                                                long long dense, int j) {
  if constexpr (kPaged) {
    return pbase[j / kv.ps - pf] + static_cast<long long>(j % kv.ps) * D;
  } else {
    return dense + static_cast<long long>(j) * D;
  }
}

// ---------------------------------------------------------------- decode ----
constexpr int kDecThreads = 128;
constexpr int kDecBK = 64;   // K/V rows per tile (two per lane in the softmax); most ranges merged

template <int D>
size_t decode_smem_floats(int G) {
  constexpr int BK = kDecBK;
  return static_cast<size_t>(G) * D           // q (pre-scaled)
       + BK * (D + 1)                         // k tile (padded: no bank conflicts)
       + BK * D                               // v tile
       + static_cast<size_t>(G) * kDecBK      // scores / probabilities; the merge's weights
       + static_cast<size_t>(G) * D           // accumulator
       + 3 * static_cast<size_t>(G);          // m, l, alpha
}

template <typename T, int D, bool kPaged>
__global__ void __launch_bounds__(kDecThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              KvRows kv, const int* __restrict__ kv_len, T* __restrict__ o,
              float* __restrict__ m_out, float* __restrict__ l_out,
              float* __restrict__ part, int* __restrict__ done,
              int hkv, int G, int split_rows, float scale) {
  constexpr int V = rt::Vec<T>::n;
  constexpr int DV = D / V;
  constexpr int BK = kDecBK;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + G * D;
  float* v_s = k_s + BK * (D + 1);
  float* p_s = v_s + BK * D;   // [G][BK] in the loop, [G][kDecBK] in the merge
  float* acc_s = p_s + G * kDecBK;
  float* m_s = acc_s + G * D;
  float* l_s = m_s + G;
  float* a_s = l_s + G;
  __shared__ bool last;
  __shared__ long long pbase[kMaxTilePages];   // paged: this tile's page offsets

  const int h = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int S = kv.nb * kv.ps;
  const int nsplit = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  constexpr int nw = kDecThreads / 32;
  int len = kv_len[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  // splits that hold at least one visible row (at least one, so an empty
  // row still writes its zeros); the others have nothing to do
  int active = (len + split_rows - 1) / split_rows;
  active = active < 1 ? 1 : active;
  if (split >= active) return;
  const int lo = split * split_rows;
  const int hi = len < lo + split_rows ? len : lo + split_rows;
  const size_t head = static_cast<size_t>(b) * hkv + h;
  const long long dense = static_cast<long long>(head) * S * D;   // dense row 0
  int pf = 0;                       // paged: table slot of pbase[0]
  const size_t qo = head * G * D;   // q/o [B, Hq, D]: this kv head's G q heads

  for (int i = tid; i < G * DV; i += kDecThreads) {
    float t[V];
    rt::load_vec(q + qo + i * V, t);
#pragma unroll
    for (int j = 0; j < V; ++j) q_s[i * V + j] = t[j] * scale;
  }
  for (int i = tid; i < G * D; i += kDecThreads) acc_s[i] = 0.f;
  for (int g = tid; g < G; g += kDecThreads) { m_s[g] = kNegInf; l_s[g] = 0.f; }
  __syncthreads();

  for (int j0 = lo; j0 < hi; j0 += BK) {
    if constexpr (kPaged) {
      pf = stage_pages<D>(kv, b, h, hkv, j0, j0 + BK < hi ? j0 + BK : hi, pbase);
      __syncthreads();
    }
    for (int i = tid; i < BK * DV; i += kDecThreads) {
      const int r = i / DV, c = (i % DV) * V;
      float kt[V], vt[V];
      if (j0 + r < hi) {
        const long long off = kv_offset<D, kPaged>(kv, pbase, pf, dense, j0 + r) + c;
        rt::load_vec(k + off, kt);
        rt::load_vec(v + off, vt);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) kt[j] = vt[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        k_s[r * (D + 1) + c + j] = kt[j];
        v_s[r * D + c + j] = vt[j];
      }
    }
    __syncthreads();

    for (int i = tid; i < G * BK; i += kDecThreads) {
      const int g = i / BK, j = i % BK;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s += q_s[g * D + d] * k_s[j * (D + 1) + d];
      p_s[i] = s;
    }
    __syncthreads();

    for (int g = wid; g < G; g += nw) {
      // tile rows lane and lane + 32 (those below BK)
      const bool in0 = lane < BK, in1 = lane + 32 < BK;
      const bool ok0 = in0 && j0 + lane < hi, ok1 = in1 && j0 + lane + 32 < hi;
      const float s0 = ok0 ? p_s[g * BK + lane] : kNegInf;
      const float s1 = ok1 ? p_s[g * BK + lane + 32] : kNegInf;
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, rt::warp_max(fmaxf(s0, s1)));
      const float p0 = ok0 ? expf(s0 - m_new) : 0.f;
      const float p1 = ok1 ? expf(s1 - m_new) : 0.f;
      if (in0) p_s[g * BK + lane] = p0;
      if (in1) p_s[g * BK + lane + 32] = p1;
      const float sum = rt::warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[g] = alpha;
        l_s[g] = alpha * l_s[g] + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * D; i += kDecThreads) {
      const int g = i / D, d = i % D;
      float a = acc_s[i] * a_s[g];
#pragma unroll 16
      for (int j = 0; j < BK; ++j) a += p_s[g * BK + j] * v_s[j * D + d];
      acc_s[i] = a;
    }
    __syncthreads();
  }

  if (active > 1) {
    // publish this split's (acc, m, l); the last split of the (row, kv
    // head) to arrive merges them all (flash-decode combine)
    float* mine = part + (head * nsplit + split) * G * (D + 2);
    for (int i = tid; i < G * D; i += kDecThreads)
      mine[(i / D) * (D + 2) + i % D] = acc_s[i];
    for (int g = tid; g < G; g += kDecThreads) {
      mine[g * (D + 2) + D] = m_s[g];
      mine[g * (D + 2) + D + 1] = l_s[g];
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(done + head, 1) == active - 1;
    __syncthreads();
    if (!last) return;
    if (tid == 0) done[head] = 0;   // every counter is 0 again for the next launch
    __threadfence();
    const float* all = part + head * nsplit * G * (D + 2);
    // w[s][g] = exp(m_s - m*) in p_s (nsplit <= 64 = kDecBK, host-capped)
    for (int g = tid; g < G; g += kDecThreads) {
      float mx = kNegInf;
      for (int sp = 0; sp < active; ++sp)
        mx = fmaxf(mx, __ldcg(all + (sp * G + g) * (D + 2) + D));
      float lsum = 0.f;
      for (int sp = 0; sp < active; ++sp) {
        const float w = expf(__ldcg(all + (sp * G + g) * (D + 2) + D) - mx);
        p_s[g * kDecBK + sp] = w;
        lsum += w * __ldcg(all + (sp * G + g) * (D + 2) + D + 1);
      }
      m_s[g] = mx;
      l_s[g] = lsum;
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += kDecThreads) {
      const int g = i / D, d = i % D;
      float a = 0.f;
      for (int sp = 0; sp < active; ++sp)
        a += p_s[g * kDecBK + sp] * __ldcg(all + (sp * G + g) * (D + 2) + d);
      acc_s[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < G * D; i += kDecThreads) {
    const float l = l_s[i / D];
    o[qo + i] = rt::from_f<T>(l == 0.f ? 0.f : acc_s[i] / l);
  }
  if (m_out != nullptr) {
    for (int g = tid; g < G; g += kDecThreads) {
      m_out[head * G + g] = m_s[g];
      l_out[head * G + g] = l_s[g];
    }
  }
}

template <typename T, int D, bool kPaged>
cudaError_t decode_launch_t(const void* q, const void* k, const void* v, KvRows kv,
                            const int* kv_len, void* o, float* m, float* l, float* part,
                            int* done, int B, int hkv, int G, int nsplit, int split_rows,
                            float scale, cudaStream_t stream) {
  const size_t smem = decode_smem_floats<D>(G) * sizeof(float);
  auto kernel = decode_kernel<T, D, kPaged>;
  cudaError_t err = rt::set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(hkv, B, nsplit), kDecThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), kv,
      kv_len, static_cast<T*>(o), m, l, part, done, hkv, G, split_rows, scale);
  return cudaGetLastError();
}

// ----------------------------------------------------------- chunk, f32 ----
// The FMA body: f32 only (bf16 takes the tensor-core kernels in namespace tc).
constexpr int kChThreads = 256;   // 16 x 16 threads, an RI x CJ register tile each

// Tiles of the f32 chunk kernel: 64 query rows against 64-row K/V tiles
// (a 4 x 4 register tile a thread).
template <int D>
struct ChTile {
  static constexpr int BQ = 64;   // query rows per block
  static constexpr int BK = 64;   // K/V rows per tile
  static constexpr int RI = BQ / 16;             // a thread's query rows
  static constexpr int CJ = BK / 16;             // a thread's columns of a tile
};

template <int D>
constexpr size_t chunk_smem_floats() {
  using C = ChTile<D>;
  return C::BQ * (D + 1) + C::BK * (D + 1) + C::BK * D + C::BQ * (C::BK + 1);
}

template <typename T, int D, bool kPaged>
__global__ void __launch_bounds__(kChThreads)
chunk_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             KvRows kv, const int* __restrict__ pos, T* __restrict__ o,
             int hkv, int G, int T_, float scale) {
  constexpr int V = rt::Vec<T>::n;
  constexpr int DV = D / V;
  constexpr int DP = D + 1;
  constexpr int BQ = ChTile<D>::BQ, BK = ChTile<D>::BK;
  constexpr int RI = ChTile<D>::RI, CJ = ChTile<D>::CJ;
  constexpr int PP = BK + 1;
  constexpr int NC = D / 16;      // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;              // [BQ][DP]
  float* k_s = q_s + BQ * DP;     // [BK][DP]
  float* v_s = k_s + BK * DP;     // [BK][D]
  float* p_s = v_s + BK * D;      // [BQ][PP]
  __shared__ long long pbase[kMaxTilePages];   // paged: this tile's page offsets

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int S = kv.nb * kv.ps;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int rows = G * T_;
  const int r0 = tile * BQ;
  const int p0 = pos[b];
  const size_t head = static_cast<size_t>(b) * hkv + h;
  const long long dense = static_cast<long long>(head) * S * D;   // dense row 0
  int pf = 0;                       // paged: table slot of pbase[0]
  // tile row r -> (t = r / G, g = r % G); q/o [B, Hq, T, D] with q head h*G+g
  auto row_offset = [&](int r) {
    return ((head * G + r % G) * T_ + r / G) * static_cast<size_t>(D);
  };

  for (int i = tid; i < BQ * DV; i += kChThreads) {
    const int rr = i / DV, c = (i % DV) * V, r = r0 + rr;
    float t[V];
    if (r < rows) {
      rt::load_vec(q + row_offset(r) + c, t);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) t[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < V; ++j) q_s[rr * DP + c + j] = t[j] * scale;
  }

  // columns any row of this tile may see: [0, pos + t_max]
  const int r_last = (r0 + BQ < rows ? r0 + BQ : rows) - 1;
  int ncols = p0 + r_last / G + 1;
  ncols = ncols > S ? S : ncols;

  float m_i[RI], l_i[RI], acc[RI][NC];
  int lim[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = r0 + ty * RI + i;
    lim[i] = r < rows ? p0 + r / G : -1;
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  __syncthreads();

  for (int c0 = 0; c0 < ncols; c0 += BK) {
    if constexpr (kPaged) {
      pf = stage_pages<D>(kv, b, h, hkv, c0, c0 + BK < ncols ? c0 + BK : ncols, pbase);
      __syncthreads();
    }
    for (int i = tid; i < BK * DV; i += kChThreads) {
      const int jj = i / DV, c = (i % DV) * V, col = c0 + jj;
      float kt[V], vt[V];
      if (col < ncols) {
        const long long off = kv_offset<D, kPaged>(kv, pbase, pf, dense, col) + c;
        rt::load_vec(k + off, kt);
        rt::load_vec(v + off, vt);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) kt[j] = vt[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        k_s[jj * DP + c + j] = kt[j];
        v_s[jj * D + c + j] = vt[j];
      }
    }
    __syncthreads();

    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RI], kv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = q_s[(ty * RI + i) * DP + d];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = k_s[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      bool ok[CJ];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int col = c0 + tx + 16 * j;
        ok[j] = col <= lim[i] && col < ncols;
        if (ok[j]) mx = fmaxf(mx, s[i][j]);
      }
      // reduce over the 16 threads (tx) that share this row
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        p_s[(ty * RI + i) * PP + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_i[i] = alpha * l_i[i] + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = v_s[j * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float p = p_s[(ty * RI + i) * PP + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] += p * vv[c];
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = r0 + ty * RI + i;
    if (r >= rows) continue;
    T* orow = o + row_offset(r);
    const float l = l_i[i];
#pragma unroll
    for (int c = 0; c < NC; ++c)
      orow[tx + 16 * c] = rt::from_f<T>(l == 0.f ? 0.f : acc[i][c] / l);
  }
}

template <typename T, int D, bool kPaged>
cudaError_t chunk_launch_t(const void* q, const void* k, const void* v, KvRows kv,
                           const int* pos, void* o, int B, int hkv, int G, int T_,
                           float scale, cudaStream_t stream) {
  constexpr size_t smem = chunk_smem_floats<D>() * sizeof(float);
  auto kernel = chunk_kernel<T, D, kPaged>;
  static const cudaError_t attr = rt::set_smem(kernel, smem);   // once per process
  if (attr != cudaSuccess) return attr;
  const int tiles = (G * T_ + ChTile<D>::BQ - 1) / ChTile<D>::BQ;
  kernel<<<dim3(tiles, hkv, B), kChThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), kv, pos,
      static_cast<T*>(o), hkv, G, T_, scale);
  return cudaGetLastError();
}

}  // namespace

// ====================================================== bf16: tensor cores ====
namespace tc {

constexpr int kChWarps = 8;             // chunk block: 8 warps, two warpgroups
constexpr int kChM = 16 * kChWarps;     // query rows per chunk block

// How a chunk block's K/V tiles reach shared memory.
enum Route : int {
  kDense = 0,      // TMA from a [B*Hkv, S, D] map
  kPagedTma = 1,   // TMA from a [P*Hkv, ps, D] map; ps a multiple of kBN
  kGather = 2,     // paged, any other page size: cp.async 16-byte chunks
};

// What the chunk kernel needs to know about the problem.
struct ChunkProblem {
  int hkv, G, T;
  int S;            // the row's length: dense S, or nb * ps
  int nb, ps;       // paged: block-table width and page size
  int split_cols;   // columns per split range, a multiple of kBN
  float mul;        // softmax scale * log2(e): scores in log2 units
  __device__ int rows() const { return G * T; }
  // the last column tile row r = (t, g) sees at offset p0 (-1: no row)
  __device__ int limit(int p0, int r) const {
    if (r >= rows()) return -1;
    const int lim = p0 + r / G;
    return lim < S - 1 ? lim : S - 1;
  }
};

// Scores to log2 units in place (chunk attention has no softcap).
struct Log2Score {
  float mul;
  __device__ __forceinline__ float operator()(float& s) const {
    s *= mul;
    return 1.f;
  }
};

template <int D>
constexpr size_t chunk_smem() {   // Q tile, the K/V ring, paged row offsets
  constexpr int DT = tile_dim<D>();
  return kChM * DT * sizeof(bf16) + KvRing<DT>::kBytes + 2 * kBN * sizeof(long long) + kAlign;
}

// One block: 128 query rows (tile blockIdx.y from the last) of (row b,
// kv head h) = blockIdx.x, columns of split range blockIdx.z.  Two blocks
// per SM (see the head note).
template <int D, int kRoute>
__global__ void __launch_bounds__(kChWarps * 32, 2)
chunk_kernel(const bf16* __restrict__ q, const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const int* __restrict__ bt,
             const int* __restrict__ pos, bf16* __restrict__ o, float* __restrict__ part,
             int* __restrict__ done, ChunkProblem pb) {
  constexpr int DT = tile_dim<D>(), NT = kChWarps * 32, NS = kBN / 8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __shared__ int last;
  bf16* q_s = reinterpret_cast<bf16*>(aligned_smem(tc_smem));
  const KvRing<DT> ring(q_s + kChM * DT);
  long long* koff = reinterpret_cast<long long*>(ring.full + 2);   // kGather: [2][kBN]
  int* pages = reinterpret_cast<int*>(koff);                        // kPagedTma: [2]

  const int head = blockIdx.x;                           // b * hkv + h
  const int b = head / pb.hkv, h = head % pb.hkv;
  const int tile = gridDim.y - 1 - blockIdx.y;           // longest tiles first
  const int r0 = tile * kChM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nrows = min(pb.rows() - r0, kChM);
  const int p0 = pos[b];
  const int ncols = pb.limit(p0, r0 + nrows - 1) + 1;   // columns any row sees
  const int active = max((ncols + pb.split_cols - 1) / pb.split_cols, 1);   // live ranges
  if (static_cast<int>(blockIdx.z) >= active) return;
  const int lo = blockIdx.z * pb.split_cols;             // this block's columns [lo, hi)
  const int hi = min(ncols, lo + pb.split_cols);
  const int ntiles = max((hi - lo + kBN - 1) / kBN, 0);
  auto q_of = [&](int rr) {   // q / o row of tile row rr = (t, g), q head h * G + g
    const int r = r0 + rr;
    return (static_cast<size_t>(head) * pb.G + r % pb.G) * pb.T + r / pb.G;
  };
  // kGather, threads < kBN: the arena offset of row threadIdx.x of tile j
  // into koff[j % 2] (-1 past hi: zero-filled), one table read per row
  auto stage_rows = [&](int j) {
    const int col = lo + j * kBN + static_cast<int>(threadIdx.x);
    long long off = -1;
    if (col < hi) {
      const long long page = bt[static_cast<size_t>(b) * pb.nb + col / pb.ps];
      off = ((page * pb.hkv + h) * pb.ps + col % pb.ps) * D;
    }
    koff[(j & 1) * kBN + threadIdx.x] = off;
  };
  // kPagedTma, one thread: tile j lies in one page (ps a multiple of
  // kBN, tiles start at multiples of kBN); its table read, into pages[j % 2]
  auto stage_page = [&](int j) {
    pages[j & 1] = bt[static_cast<size_t>(b) * pb.nb + (lo + j * kBN) / pb.ps];
  };
  // kPagedTma, one thread: start loading tile j from its page
  auto load_page = [&](int j) {
    ring.load_at(&tk, &tv, pages[j & 1] * pb.hkv + h, j, (lo + j * kBN) % pb.ps);
  };
  // kGather: start copying tile j into its ring stage, 16 bytes a thread
  auto gather = [&](int j) {
    constexpr int C = D / 8;
#pragma unroll
    for (int it = 0; it < (kBN * C + NT - 1) / NT; ++it) {
      const int i = it * NT + static_cast<int>(threadIdx.x), r = i / C, c = i % C;
      if (i < kBN * C) {
        const long long off = koff[(j & 1) * kBN + r];
        const bool ok = off >= 0;
        const int at = tile_off<DT, kBN>(r, c);
        mma::cp_async16(ring.k(j) + at, ok ? k + off + c * 8 : k, ok);
        mma::cp_async16(ring.v(j) + at, ok ? v + off + c * 8 : v, ok);
      }
    }
  };

  if constexpr (kRoute == kGather) {
    if (threadIdx.x < kBN) {
      stage_rows(0);
      stage_rows(1);
    }
    __syncthreads();
    if (ntiles > 0) gather(0);
  } else if constexpr (kRoute == kPagedTma) {
    if (threadIdx.x == 0) {
      ring.init();
      if (ntiles > 0) {
        stage_page(0);
        load_page(0);
      }
      if (ntiles > 1) stage_page(1);
    }
  } else if (threadIdx.x == 0) {
    ring.init();
    if (ntiles > 0) ring.load_at(&tk, &tv, head, 0, lo);
  }
  load_rows<DT, kChM, NT, D>(q_s, q, nrows, q_of);
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  mma::fence_async_smem();
  __syncthreads();   // Q (kGather: and tile 0) has landed, the ring's barriers are set

  const int rw = warp * 16 + (lane >> 2);   // this thread's rows: rw, rw + 8
  const int lim[2] = {pb.limit(p0, r0 + rw), pb.limit(p0, r0 + rw + 8)};
  // the tile's first row sees the fewest columns; rows past the last
  // valid one may go unmasked: their zero Q gives finite p, never stored
  const int lim_lo = pb.limit(p0, r0);
  const bool idle = (warp >> 2) * 64 >= nrows;   // a warpgroup with no rows
  const Log2Score score{pb.mul};
  float acc[DT / 8][4] = {};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // m in log2 units

  for (int j = 0; j < ntiles; ++j) {
    if constexpr (kRoute == kGather) {
      if (j + 1 < ntiles) gather(j + 1);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
      mma::fence_async_smem();
      __syncthreads();   // tile j has landed
    } else {
      if (threadIdx.x == 0 && j + 1 < ntiles) {
        if constexpr (kRoute == kPagedTma)
          load_page(j + 1);
        else
          ring.load_at(&tk, &tv, head, j + 1, lo + (j + 1) * kBN);
      }
      ring.wait(j);
    }
    if (!idle) {
      float s[NS][4] = {}, alpha[2];
      mma::fence_regs(s);
      mma::wgmma_fence();
      issue_abt<DT, kChM, D>(s, q_s, (warp >> 2) * 64, ring.k(j));   // S = Q K^T
      mma::wgmma_commit();
      // tile j + 2's table reads, under the product (warps 0-1: never idle)
      if constexpr (kRoute == kGather) {
        if (threadIdx.x < kBN && j + 2 < ntiles) stage_rows(j + 2);
      } else if constexpr (kRoute == kPagedTma) {
        if (threadIdx.x == 0 && j + 2 < ntiles) stage_page(j + 2);
      }
      mma::wgmma_wait<0>();
      mma::fence_regs(s);
      const int c0 = lo + j * kBN;
      const int cb = c0 + (lane & 3) * 2;
      if (c0 + kBN - 1 <= lim_lo)   // every row sees the whole tile
        online_softmax<false>(s, m, l, alpha, cb, lim, score);
      else
        online_softmax<true>(s, m, l, alpha, cb, lim, score);
#pragma unroll
      for (int n = 0; n < DT / 8; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
      uint32_t pa[NS / 2][4];
      mma::to_a<NS>(pa, s);
      mma::fence_regs(acc);
      mma::fence_regs(pa);
      mma::wgmma_fence();
      issue_pb<DT>(acc, pa, ring.v(j));   // O += P V
      mma::wgmma_commit();
      mma::wgmma_wait<0>();
      mma::fence_regs(acc);
    }
    __syncthreads();   // stage j & 1 is refilled next iteration
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  if (active == 1) {   // the tile's only range: normalize and store
    const float inv0 = l[0] == 0.f ? 0.f : 1.f / l[0], inv1 = l[1] == 0.f ? 0.f : 1.f / l[1];
    acc_to_tile<DT, kChM>(q_s, warp * 16, acc, inv0, inv1);   // the warp's own Q rows
    __syncwarp();
    store_rows<DT, kChM, D>(q_s, o, warp * 16, nrows, q_of);
    return;
  }

  // Split: publish this range's (acc, m, l) rows; the last of the tile's
  // live ranges to arrive merges them all.  part holds every block's
  // [kChM, D] accumulators, then every block's [kChM, 2] (m, l).
  const size_t base = (static_cast<size_t>(head) * gridDim.y + tile) * gridDim.z;   // range 0
  float* pml = part + static_cast<size_t>(gridDim.x) * gridDim.y * gridDim.z * kChM * D;
  {
    const size_t slot = base + blockIdx.z;
    float* pacc = part + slot * kChM * D;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rw + 8 * i;
      if (r >= nrows) continue;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<float2*>(pacc + r * D + n * 8 + (lane & 3) * 2) =
            make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
      if ((lane & 3) == 0)
        *reinterpret_cast<float2*>(pml + (slot * kChM + r) * 2) = make_float2(m[i], l[i]);
    }
  }
  __threadfence();
  __syncthreads();
  const size_t ctr = static_cast<size_t>(head) * gridDim.y + tile;
  if (threadIdx.x == 0) last = atomicAdd(done + ctr, 1) == active - 1;
  __syncthreads();
  if (!last) return;
  if (threadIdx.x == 0) done[ctr] = 0;   // every counter is 0 again for the next launch
  __threadfence();
  float* row_m = reinterpret_cast<float*>(q_s);   // per row: max over ranges, 1 / sum
  float* row_inv = row_m + kChM;
  auto ml_of = [&](int sp, int r) {   // range sp's (m, l) of row r
    return __ldcg(reinterpret_cast<const float2*>(pml + ((base + sp) * kChM + r) * 2));
  };
  for (int r = threadIdx.x; r < nrows; r += NT) {
    float mx = kNegInf;
    for (int sp = 0; sp < active; ++sp) mx = fmaxf(mx, ml_of(sp, r).x);
    float sum = 0.f;
    for (int sp = 0; sp < active; ++sp) {
      const float2 ml = ml_of(sp, r);
      sum += exp2f(ml.x - mx) * ml.y;
    }
    row_m[r] = mx;
    row_inv[r] = sum == 0.f ? 0.f : 1.f / sum;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nrows * (D / 4); i += NT) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sp = 0; sp < active; ++sp) {
      const float w = exp2f(ml_of(sp, r).x - row_m[r]);
      const float4 x =
          __ldcg(reinterpret_cast<const float4*>(part + ((base + sp) * kChM + r) * D + c));
      a.x += w * x.x;
      a.y += w * x.y;
      a.z += w * x.z;
      a.w += w * x.w;
    }
    const float inv = row_inv[r];
    uint2 u;
    u.x = mma::pack_bf16(a.x * inv, a.y * inv);
    u.y = mma::pack_bf16(a.z * inv, a.w * inv);
    *reinterpret_cast<uint2*>(o + q_of(r) * D + c) = u;
  }
}

// ------------------------------------------------------------ decode, bf16 ----
constexpr int kDecWarps = 4;    // decode block: 4 warps, each 16 rows of every K/V tile
constexpr int kDecRows = 16;    // q heads per block: one m16 A tile (zero rows past G)
constexpr float kLn2 = 0.6931471805599453f;

// Ring stages of the decode kernel: 16 KB a stage at D 64 (four stages,
// three blocks per SM), 32 KB at tile width 128 (D 80, 128: three stages,
// two blocks per SM).
template <int D>
__host__ __device__ constexpr int dec_stages() {
  return tile_dim<D>() > 64 ? 3 : 4;
}

// What the decode kernel needs to know about the problem.
struct DecodeProblem {
  int hkv, G, hg;       // kv heads, q heads per kv head, blocks of kDecRows of them
  int nb, ps;           // rows: dense nb = 1, ps = S; paged table width, page size
  int split_rows;       // rows per split range, a multiple of kBN
  float mul;            // softmax scale * log2(e): scores in log2 units
};

template <int D>
size_t decode_smem(bool paged, int split_rows) {   // the ring, the range's page ids
  return kAlign + KvRing<tile_dim<D>(), dec_stages<D>()>::kBytes +
         (paged ? (split_rows + 2) * sizeof(int) : 0);
}

// One block: the q heads [16 grp, 16 grp + 16) of (row b, kv head h)
// against split range blockIdx.y of the row's visible K/V (see the head
// note).  unit = blockIdx.x = (b * hkv + h) * hg + grp.
template <int D, int kRoute>
__global__ void __launch_bounds__(kDecWarps * 32)
decode_kernel(const bf16* __restrict__ q, const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const int* __restrict__ bt,
              const int* __restrict__ kv_len, bf16* __restrict__ o, float* __restrict__ m_out,
              float* __restrict__ l_out, float* __restrict__ part, int* __restrict__ done,
              DecodeProblem pb) {
  constexpr int DT = tile_dim<D>(), NS = dec_stages<D>(), NT = kDecWarps * 32;
  constexpr int KS = D / 16;   // k-steps of Q K^T; also n-tile pairs of P V
  constexpr int RW = D + 2;    // a reduced row: acc [D], m, l
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __shared__ int last;
  __shared__ float row_m[kDecRows], row_l[kDecRows], row_w[kDecRows][kDecWarps];
  const KvRing<DT, NS> ring(aligned_smem(tc_smem));
  int* pid = reinterpret_cast<int*>(ring.full + NS);   // paged: the range's page ids

  const int unit = blockIdx.x, grp = unit % pb.hg, head = unit / pb.hg;
  const int b = head / pb.hkv, h = head % pb.hkv;
  const int split = blockIdx.y;
  const int S = pb.nb * pb.ps;
  const int len = min(max(kv_len[b], 0), S);
  // ranges that hold a visible row (at least one: an empty row writes zeros)
  const int active = max((len + pb.split_rows - 1) / pb.split_rows, 1);
  if (split >= active) return;
  const int lo = split * pb.split_rows, hi = min(len, lo + pb.split_rows);
  const int ntiles = max((hi - lo + kBN - 1) / kBN, 0);
  const int rows = min(pb.G - grp * kDecRows, kDecRows);
  const int R = min(pb.G, kDecRows);   // rows of a partial
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, qd = lane & 3;
  const int mi = lane >> 3;            // the ldmatrix matrix whose row this lane addresses
  const size_t q0 = static_cast<size_t>(head) * pb.G + grp * kDecRows;   // q/o row of tile row 0
  const int slot0 = lo / pb.ps;

  if constexpr (kRoute != kDense) {
    const int nslots = ntiles > 0 ? (hi - 1) / pb.ps - slot0 + 1 : 0;
    const int* row = bt + static_cast<size_t>(b) * pb.nb + slot0;
    for (int i = threadIdx.x; i < nslots; i += NT) pid[i] = row[i];
  }
  if (kRoute != kGather && threadIdx.x == 0) ring.init();
  __syncthreads();   // page ids staged, barriers set

  // start loading tile j (rows lo + j kBN ...) into its ring stage
  auto issue = [&](int j) {
    const int row0 = lo + j * kBN;
    if constexpr (kRoute == kDense) {
      if (threadIdx.x == 0) ring.load_at(&tk, &tv, head, j, row0);
    } else if constexpr (kRoute == kPagedTma) {   // a tile lies in one page
      if (threadIdx.x == 0)
        ring.load_at(&tk, &tv, pid[row0 / pb.ps - slot0] * pb.hkv + h, j, row0 % pb.ps);
    } else {   // kGather: 16-byte chunks, rows past hi zero-filled
      constexpr int C = D / 8;
      for (int i = threadIdx.x; i < kBN * C; i += NT) {
        const int r = i / C, c = i % C, row = row0 + r;
        const bool ok = row < hi;
        long long off = 0;
        if (ok)
          off = ((static_cast<long long>(pid[row / pb.ps - slot0]) * pb.hkv + h) * pb.ps +
                 row % pb.ps) * D + c * 8;
        const int at = tile_off<DT, kBN>(r, c);
        mma::cp_async16(ring.k(j) + at, k + off, ok);
        mma::cp_async16(ring.v(j) + at, v + off, ok);
      }
    }
  };
  for (int j = 0; j < NS; ++j) {   // every stage in flight from the start
    if (j < ntiles) issue(j);
    if constexpr (kRoute == kGather) mma::cp_async_commit();
  }

  // Q rows g and g + 8 (q heads past G are zero) as the A operand, unscaled
  uint32_t qa[KS][4];
  {
    const bf16* r0 = q + (q0 + g) * D;
    const bf16* r1 = r0 + 8 * D;
    const bool ok0 = g < rows, ok1 = g + 8 < rows;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int c = 16 * kk + 2 * qd;
      qa[kk][0] = ok0 ? *reinterpret_cast<const uint32_t*>(r0 + c) : 0u;
      qa[kk][1] = ok1 ? *reinterpret_cast<const uint32_t*>(r1 + c) : 0u;
      qa[kk][2] = ok0 ? *reinterpret_cast<const uint32_t*>(r0 + c + 8) : 0u;
      qa[kk][3] = ok1 ? *reinterpret_cast<const uint32_t*>(r1 + c + 8) : 0u;
    }
  }

  const Log2Score score{pb.mul};
  float acc[D / 8][4] = {};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // m in log2 units
  for (int j = 0; j < ntiles; ++j) {
    if constexpr (kRoute == kGather) {
      mma::cp_async_wait<NS - 1>();
      __syncthreads();   // tile j has landed, for every thread
    } else {
      ring.wait(j);
    }
    const bf16* kt = ring.k(j);
    const bf16* vt = ring.v(j);
    // S = Q K^T over this warp's 16 rows of the tile (two n-tiles)
    float s[2][4] = {}, alpha[2];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t kb[4];
      mma::ldsm_x4(kb, kt + tile_off<DT, kBN>(16 * warp + (mi >> 1) * 8 + (lane & 7),
                                              2 * kk + (mi & 1)));
      mma::mma_bf16(s[0], qa[kk], kb[0], kb[1]);
      mma::mma_bf16(s[1], qa[kk], kb[2], kb[3]);
    }
    const int c0 = lo + j * kBN + 16 * warp;   // this warp's first column
    const int lim[2] = {hi - 1, hi - 1};
    if (c0 + 15 < hi)
      online_softmax<false>(s, m, l, alpha, c0 + 2 * qd, lim, score);
    else
      online_softmax<true>(s, m, l, alpha, c0 + 2 * qd, lim, score);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    // O += P V: P rounded to bf16 as the A operand (k = the warp's 16 rows)
    const uint32_t pa[4] = {mma::pack_bf16(s[0][0], s[0][1]), mma::pack_bf16(s[0][2], s[0][3]),
                            mma::pack_bf16(s[1][0], s[1][1]), mma::pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int np = 0; np < KS; ++np) {
      uint32_t vb[4];
      mma::ldsm_x4_t(vb, vt + tile_off<DT, kBN>(16 * warp + (mi & 1) * 8 + (lane & 7),
                                                2 * np + (mi >> 1)));
      mma::mma_bf16(acc[2 * np], pa, vb[0], vb[1]);
      mma::mma_bf16(acc[2 * np + 1], pa, vb[2], vb[3]);
    }
    __syncthreads();   // every warp is done with this stage: refill it
    if (j + NS < ntiles) issue(j + NS);
    if constexpr (kRoute == kGather) mma::cp_async_commit();
  }
  if constexpr (kRoute == kGather) mma::cp_async_wait<0>();

  // Reduce the four warps' (acc, m, l) in warp order, through the ring
  // (every load has landed and been read).
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  float* red = reinterpret_cast<float*>(ring.tiles);   // [warp][row][RW]
  {
    float* r0 = red + (warp * kDecRows + g) * RW;
    float* r1 = r0 + 8 * RW;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<float2*>(r0 + 8 * n + 2 * qd) = make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(r1 + 8 * n + 2 * qd) = make_float2(acc[n][2], acc[n][3]);
    }
    if (qd == 0) {
      r0[D] = m[0];
      r0[D + 1] = l[0];
      r1[D] = m[1];
      r1[D + 1] = l[1];
    }
  }
  __syncthreads();
  if (threadIdx.x < rows) {
    const int r = threadIdx.x;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) mx = fmaxf(mx, red[(w * kDecRows + r) * RW + D]);
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      const float e = exp2f(red[(w * kDecRows + r) * RW + D] - mx);
      row_w[r][w] = e;
      sum += e * red[(w * kDecRows + r) * RW + D + 1];
    }
    row_m[r] = mx;
    row_l[r] = sum;
  }
  __syncthreads();
  auto reduced = [&](int r, int d) {   // the block's acc of row r, column d
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) a += row_w[r][w] * red[(w * kDecRows + r) * RW + d];
    return a;
  };
  // write a row's output and residuals from its (m, l) and acc(d)
  auto finish = [&](auto acc_of) {
    for (int i = threadIdx.x; i < rows * D; i += NT) {
      const int r = i / D, d = i % D;
      const float lr = row_l[r];
      o[(q0 + r) * D + d] = __float2bfloat16_rn(lr == 0.f ? 0.f : acc_of(r, d) / lr);
    }
    if (m_out != nullptr && threadIdx.x < rows) {
      const int r = threadIdx.x;
      m_out[q0 + r] = row_l[r] == 0.f ? kNegInf : row_m[r] * kLn2;
      l_out[q0 + r] = row_l[r];
    }
  };
  if (active == 1) {   // the row's only range
    finish(reduced);
    return;
  }

  // Split: publish this range's rows (acc, m, l); the last of the unit's
  // live ranges to arrive merges them all, in range order.
  const size_t base = static_cast<size_t>(unit) * gridDim.y;   // range 0's partial
  {
    float* mine = part + (base + split) * R * RW;
    for (int i = threadIdx.x; i < rows * RW; i += NT) {
      const int r = i / RW, d = i % RW;
      mine[r * RW + d] = d < D ? reduced(r, d) : d == D ? row_m[r] : row_l[r];
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done + unit, 1) == active - 1;
  __syncthreads();
  if (!last) return;
  if (threadIdx.x == 0) done[unit] = 0;   // every counter is 0 again for the next launch
  __threadfence();
  const float* all = part + base * R * RW;
  if (threadIdx.x < rows) {
    const int r = threadIdx.x;
    float mx = kNegInf;
    for (int sp = 0; sp < active; ++sp) mx = fmaxf(mx, __ldcg(all + (sp * R + r) * RW + D));
    float sum = 0.f;
    for (int sp = 0; sp < active; ++sp)
      sum += exp2f(__ldcg(all + (sp * R + r) * RW + D) - mx) *
             __ldcg(all + (sp * R + r) * RW + D + 1);
    row_m[r] = mx;
    row_l[r] = sum;
  }
  __syncthreads();
  finish([&](int r, int d) {
    float a = 0.f;
    for (int sp = 0; sp < active; ++sp)
      a += exp2f(__ldcg(all + (sp * R + r) * RW + D) - row_m[r]) *
           __ldcg(all + (sp * R + r) * RW + d);
    return a;
  });
}

}  // namespace tc

namespace {

// A paged K/V tile comes by TMA when it lies in one page (ps a multiple
// of 64, as the serving pool's 64); every other page size takes the
// cp.async gather, which was faster than one TMA box per page at 16.
bool tma_pages(int ps) { return ps % tc::kBN == 0; }

// What a decode launch takes besides its tensors (pages: the arena's page
// count, paged only).
struct DecodeArgs {
  int B, hkv, G, nsplit, split_rows, pages;
  float scale;
};

// bf16: the tensor-core kernel.  Grid: (b, kv head, group of 16 q heads)
// x split ranges.
template <int D, int kRoute>
cudaError_t decode_bf16(const void* q, const void* k, const void* v, KvRows kv,
                        const int* kv_len, void* o, float* m, float* l, float* part, int* done,
                        const DecodeArgs& a, cudaStream_t s) {
  using tc::bf16;
  constexpr int DT = tc::tile_dim<D>();
  CUtensorMap tk{}, tv{};
  cudaError_t err = cudaSuccess;
  if constexpr (kRoute == tc::kDense)   // kv.ps is S
    err = tc::kv_maps<DT>(&tk, &tv, k, v, a.B * a.hkv, kv.ps, D, D);
  else if constexpr (kRoute == tc::kPagedTma)
    err = tc::kv_maps<DT>(&tk, &tv, k, v, a.pages * a.hkv, kv.ps, D, D);
  if (err != cudaSuccess) return err;
  const int hg = (a.G + tc::kDecRows - 1) / tc::kDecRows;
  const tc::DecodeProblem pb{a.hkv, a.G, hg, kv.nb, kv.ps, a.split_rows, a.scale * tc::kLog2e};
  const size_t smem = tc::decode_smem<D>(kRoute != tc::kDense, a.split_rows);
  auto kernel = tc::decode_kernel<D, kRoute>;
  static size_t granted = 48 * 1024;   // the paged ring grows with split_rows
  if (smem > granted) {
    err = rt::set_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    granted = smem;
  }
  kernel<<<dim3(a.B * a.hkv * hg, a.nsplit), tc::kDecWarps * 32, smem, s>>>(
      static_cast<const bf16*>(q), tk, tv, static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), kv.bt, kv_len, static_cast<bf16*>(o), m, l, part, done, pb);
  return cudaGetLastError();
}

// The decode kernel for (dtype, D, dense or paged): bf16 on the tensor
// cores, f32 on the FMA body.
template <int D>
cudaError_t decode_pick(int dtype, const void* q, const void* k, const void* v, KvRows kv,
                        const int* kv_len, void* o, float* m, float* l, float* part, int* done,
                        const DecodeArgs& a, cudaStream_t s) {
  const bool paged = kv.bt != nullptr;
  switch (dtype) {
    case rt::kBF16:
      if (!paged)
        return decode_bf16<D, tc::kDense>(q, k, v, kv, kv_len, o, m, l, part, done, a, s);
      return tma_pages(kv.ps)
                 ? decode_bf16<D, tc::kPagedTma>(q, k, v, kv, kv_len, o, m, l, part, done, a, s)
                 : decode_bf16<D, tc::kGather>(q, k, v, kv, kv_len, o, m, l, part, done, a, s);
    case rt::kF32:
      return paged ? decode_launch_t<float, D, true>(q, k, v, kv, kv_len, o, m, l, part, done,
                                                     a.B, a.hkv, a.G, a.nsplit, a.split_rows,
                                                     a.scale, s)
                   : decode_launch_t<float, D, false>(q, k, v, kv, kv_len, o, m, l, part, done,
                                                      a.B, a.hkv, a.G, a.nsplit, a.split_rows,
                                                      a.scale, s);
    default: return cudaErrorInvalidValue;
  }
}

int decode_common(const void* q, const void* k, const void* v, KvRows kv, const void* kv_len,
                  void* o, void* m, void* l, void* part, void* done, int D, const DecodeArgs& a,
                  int dtype, void* stream) {
  if (a.B <= 0 || a.hkv <= 0 || a.G <= 0) return cudaSuccess;
  // the ranges are whole tiles and cover the row's length S = nb * ps
  if (kv.nb < 1 || kv.ps < 1 || a.nsplit < 1 || a.nsplit > kDecBK || a.split_rows < kDecBK ||
      a.split_rows % kDecBK != 0 ||
      static_cast<long long>(a.nsplit) * a.split_rows < static_cast<long long>(kv.nb) * kv.ps ||
      (a.nsplit > 1 && (part == nullptr || done == nullptr)))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(kv_len);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  float* pf = static_cast<float*>(part);
  int* dn = static_cast<int*>(done);
  switch (D) {
    case 32: return decode_pick<32>(dtype, q, k, v, kv, len, o, mf, lf, pf, dn, a, s);
    case 64: return decode_pick<64>(dtype, q, k, v, kv, len, o, mf, lf, pf, dn, a, s);
    case 80: return decode_pick<80>(dtype, q, k, v, kv, len, o, mf, lf, pf, dn, a, s);
    case 128: return decode_pick<128>(dtype, q, k, v, kv, len, o, mf, lf, pf, dn, a, s);
    default: return cudaErrorInvalidValue;
  }
}

// What a chunk launch takes besides its tensors (pages: the arena's page
// count, paged only).
struct ChunkArgs {
  int B, hkv, G, T, nsplit, split_cols, pages;
  float scale;
};

// bf16: the tensor-core kernel.  Grid: (b, kv head) x query tiles x split
// ranges.
template <int D, int kRoute>
cudaError_t chunk_bf16(const void* q, const void* k, const void* v, KvRows kv, const int* pos,
                       void* o, float* part, int* done, const ChunkArgs& a, cudaStream_t s) {
  using tc::bf16;
  constexpr int DT = tc::tile_dim<D>();
  CUtensorMap tk{}, tv{};
  cudaError_t err = cudaSuccess;
  if constexpr (kRoute == tc::kDense)   // kv.ps is S
    err = tc::kv_maps<DT>(&tk, &tv, k, v, a.B * a.hkv, kv.ps, D, D);
  else if constexpr (kRoute == tc::kPagedTma)
    err = tc::kv_maps<DT>(&tk, &tv, k, v, a.pages * a.hkv, kv.ps, D, D);
  if (err != cudaSuccess) return err;
  const tc::ChunkProblem pb{a.hkv, a.G, a.T, kv.nb * kv.ps, kv.nb, kv.ps, a.split_cols,
                            a.scale * tc::kLog2e};
  constexpr size_t smem = tc::chunk_smem<D>();
  auto kernel = tc::chunk_kernel<D, kRoute>;
  static const cudaError_t attr = rt::set_smem(kernel, smem);   // once per process
  if (attr != cudaSuccess) return attr;
  const int tiles = (a.G * a.T + tc::kChM - 1) / tc::kChM;
  kernel<<<dim3(a.B * a.hkv, tiles, a.nsplit), tc::kChWarps * 32, smem, s>>>(
      static_cast<const bf16*>(q), tk, tv, static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), kv.bt, pos, static_cast<bf16*>(o), part, done, pb);
  return cudaGetLastError();
}

// The chunk kernel for (dtype, D, dense or paged): bf16 on the tensor
// cores, f32 on the FMA body (which does not split).
template <int D>
cudaError_t chunk_pick(int dtype, const void* q, const void* k, const void* v, KvRows kv,
                       const int* pos, void* o, float* part, int* done, const ChunkArgs& a,
                       cudaStream_t s) {
  const bool paged = kv.bt != nullptr;
  switch (dtype) {
    case rt::kBF16:
      if (!paged) return chunk_bf16<D, tc::kDense>(q, k, v, kv, pos, o, part, done, a, s);
      return tma_pages(kv.ps)
                 ? chunk_bf16<D, tc::kPagedTma>(q, k, v, kv, pos, o, part, done, a, s)
                 : chunk_bf16<D, tc::kGather>(q, k, v, kv, pos, o, part, done, a, s);
    case rt::kF32:
      if (a.nsplit != 1) return cudaErrorInvalidValue;
      return paged ? chunk_launch_t<float, D, true>(q, k, v, kv, pos, o, a.B, a.hkv, a.G, a.T,
                                                    a.scale, s)
                   : chunk_launch_t<float, D, false>(q, k, v, kv, pos, o, a.B, a.hkv, a.G, a.T,
                                                     a.scale, s);
    default: return cudaErrorInvalidValue;
  }
}

int chunk_common(const void* q, const void* k, const void* v, KvRows kv, const void* pos,
                 void* o, void* part, void* done, int D, const ChunkArgs& a, int dtype,
                 void* stream) {
  if (a.B <= 0 || a.hkv <= 0 || a.G <= 0 || a.T <= 0) return cudaSuccess;
  // the ranges are whole tiles and cover the row's length S = nb * ps
  if (kv.nb < 1 || kv.ps < 1 || a.nsplit < 1 || a.nsplit > kDecBK || a.split_cols < tc::kBN ||
      a.split_cols % tc::kBN != 0 ||
      static_cast<long long>(a.nsplit) * a.split_cols < static_cast<long long>(kv.nb) * kv.ps ||
      (a.nsplit > 1 && (part == nullptr || done == nullptr)))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  float* pf = static_cast<float*>(part);
  int* dn = static_cast<int*>(done);
  switch (D) {
    case 32: return chunk_pick<32>(dtype, q, k, v, kv, p, o, pf, dn, a, s);
    case 64: return chunk_pick<64>(dtype, q, k, v, kv, p, o, pf, dn, a, s);
    case 80: return chunk_pick<80>(dtype, q, k, v, kv, p, o, pf, dn, a, s);
    case 128: return chunk_pick<128>(dtype, q, k, v, kv, p, o, pf, dn, a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: [B, Hkv*G, D]; k, v: [B, Hkv, S, D]; kv_len: [B] int32; o like q;
// m, l: [B, Hkv*G] f32 or both null.  S is cut into `nsplit` ranges of
// `split_rows` rows (a multiple of 64, nsplit * split_rows >= S,
// nsplit <= 64), one block each; with nsplit > 1, `part` is f32 scratch
// of B*Hkv*ceil(G/16)*nsplit*R*(D+2) values (R = min(G, 16))
// and `done` as many int32 counters as there are (row, kv head, group of
// 16 q heads), all 0 (every launch leaves them 0).  Returns the launch's
// CUDA error.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* kv_len, void* o, void* m, void* l,
                                       void* part, void* done, int B, int hkv, int G, int S,
                                       int D, int nsplit, int split_rows, float scale,
                                       int dtype, void* stream) {
  return decode_common(q, k, v, KvRows{nullptr, 1, S}, kv_len, o, m, l, part, done, D,
                       DecodeArgs{B, hkv, G, nsplit, split_rows, 0, scale}, dtype, stream);
}

// As decode_attention_launch over a page arena: k, v: [P, Hkv, ps, D];
// bt: [B, nb] int32 page ids; the split ranges cut the virtual S = nb*ps.
extern "C" int decode_attention_paged_launch(const void* q, const void* k, const void* v,
                                             const void* bt, const void* kv_len, void* o,
                                             void* part, void* done, int B, int hkv, int G,
                                             int P, int nb, int ps, int D, int nsplit,
                                             int split_rows, float scale, int dtype,
                                             void* stream) {
  if (bt == nullptr || P < 1) return cudaErrorInvalidValue;
  return decode_common(q, k, v, KvRows{static_cast<const int*>(bt), nb, ps}, kv_len, o,
                       nullptr, nullptr, part, done, D,
                       DecodeArgs{B, hkv, G, nsplit, split_rows, P, scale}, dtype, stream);
}

// q: [B, Hkv*G, T, D]; k, v: [B, Hkv, S, D]; pos: [B] int32; o like q.
// bf16 cuts S into `nsplit` ranges of `split_cols` columns (a multiple of
// 64, nsplit * split_cols >= S, nsplit <= 64), one block each; with
// nsplit > 1, `part` is f32 scratch of B*Hkv*tiles*nsplit*128*(D+2)
// values (tiles = ceil(G*T / 128)) and `done`
// B*Hkv*tiles int32 zeros.
// f32 takes nsplit = 1 only.  Returns the launch's CUDA error.
extern "C" int chunk_attention_launch(const void* q, const void* k, const void* v,
                                      const void* pos, void* o, void* part, void* done, int B,
                                      int hkv, int G, int T, int S, int D, int nsplit,
                                      int split_cols, float scale, int dtype, void* stream) {
  return chunk_common(q, k, v, KvRows{nullptr, 1, S}, pos, o, part, done, D,
                      ChunkArgs{B, hkv, G, T, nsplit, split_cols, 0, scale}, dtype, stream);
}

// As chunk_attention_launch over a page arena: k, v: [P, Hkv, ps, D];
// bt: [B, nb] int32 page ids; the split ranges cut the virtual S = nb*ps.
extern "C" int chunk_attention_paged_launch(const void* q, const void* k, const void* v,
                                            const void* bt, const void* pos, void* o,
                                            void* part, void* done, int B, int hkv, int G,
                                            int T, int P, int nb, int ps, int D, int nsplit,
                                            int split_cols, float scale, int dtype,
                                            void* stream) {
  if (bt == nullptr || P < 1) return cudaErrorInvalidValue;
  return chunk_common(q, k, v, KvRows{static_cast<const int*>(bt), nb, ps}, pos, o, part, done,
                      D, ChunkArgs{B, hkv, G, T, nsplit, split_cols, P, scale}, dtype, stream);
}
