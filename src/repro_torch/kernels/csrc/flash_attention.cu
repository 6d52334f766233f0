// Blockwise GQA flash attention for Hopper: forward and FlashAttention-2
// backward, on the tensor cores for bf16 and on the CUDA cores for f32.
//
// What each kernel replaces.  The forward replaces the Pallas TPU kernel
// repro/kernels/flash_attention.py::flash_attention (_flash_kernel):
// causal or non-causal attention of q [B, Hq, Sq, D] against k, v
// [B, Hkv, Sk, D] with an optional tanh logit softcap; its oracle is
// repro/kernels/ref.py::attention (the plain version here:
// kernels/ref.py::attention).  It also writes the f32 log-sum-exp of each
// row, lse [B, Hq, Sq], for the backward.  The Pallas kernel is
// forward-only; the backward computes what the reference's custom VJP
// repro/kernels/ref.py::_flash_chunked_bwd_impl computes (plain version:
// kernels/ref.py::attention_backward): p = exp(s - lse),
// delta = rowsum(dO * O), dS = p * (dP - delta) (times 1 - tanh^2(s/c)
// under a softcap), dV = P^T dO, dK = scale * dS^T q, dQ = scale * dS K.
//
// What bounds it.  Operations, at training shapes: at Sq = Sk = 2048,
// D = 64 a q row does ~S/2 * 4 * D FLOPs for ~2 * D * 2 bytes of K/V per
// column, far above the ~295 FLOP/byte where the H100 stops being
// memory-bound.  So bf16 products go to the tensor cores (989 TFLOP/s
// dense) and not the FMA pipes (67 TFLOP/s in f32).
//
// bf16 design (namespace tc).  MMA route: wgmma.mma_async m64nNk16 (bf16
// in, f32 accumulate), issued by warpgroups of 128 threads, each owning
// 64 rows of every product.  Products of the form A B^T over the head dim
// (S = Q K^T and its kin) read both operands from shared memory, K-major;
// products over a score tile's columns (O += P V and its kin) take the
// score tile, rounded to bf16, as the register A operand -- a wgmma's f32
// D layout is per warp the register A layout of the next wgmma -- and
// read B MN-major (transposed) from shared memory, so P and dS never
// touch shared memory.  Shared tiles are in the canonical swizzled
// layouts the descriptors name: 128-byte swizzle in 64-column panels for
// D >= 64, 64-byte swizzle for D = 32, each tile at a 1024-byte boundary.
//   - forward: 2 warpgroups, a 128-row query tile (64 rows each), K/V
//     tiles of 64 rows.
//   - dK/dV: 1 warpgroup, a 64-row K/V tile; query steps of 64 rows (32
//     at D 80, 128 and 192, for registers).  The products are transposed so that
//     kv rows are the M dimension: S^T = K Q^T, dP^T = V dO^T, then
//     dS^T = P^T o (dP^T - delta), dV += P^T dO, dK += dS^T Q; lse, delta
//     and each query row's last visible column are staged in shared
//     memory beside Q and dO.
//   - dQ: 1 warpgroup, a 64-row query tile, K/V tiles of 64 rows: S = Q K^T,
//     dP = dO V^T, dQ += dS K.
// D 80 (zamba2's shared block) runs on the 128-column tile layout, as the
// chunk kernels do: the K/V maps hold 80 columns, so TMA zero-fills
// columns 80-127; the products over the head dim (S = Q K^T, dP = dO V^T
// and their transposes) skip the k-steps past 80 (5 of 8 run); the
// products into a [*, D] accumulator run at n 128, and only 80 columns
// are stored.  Shared memory and registers are those of D 128.
// MLA training (deepseek-v2's expanded branch) attends at q/k head dim
// D = dn + dr = 192 with v at dv = 128.  The reference pads v to 192 so
// that its Pallas kernel sees equal head dims, and drops o's zero columns
// 128-191; these kernels take v at its own width (Dv) and compute the same
// function on v's real columns.  Every kernel is templated on (D, Dv):
// S = Q K^T, dK and dQ run at D (three 64-column panels at 192), while the
// forward's O accumulator, the delta pre-pass, dP = dO V^T, dV and the
// stored o / dv run at Dv.  Why not a padded v: dK/dV holds dK and dV in
// registers for its 64 K/V rows, 96 + 96 f32 a thread at 192, which with
// S^T and dP^T leaves nothing for addressing; at Dv 128 they take 96 + 64.
// The K/V ring holds K at D's width and V at Dv's.  Shared memory at
// (192, 128): forward Q 48 KB + two 40 KB stages; dK/dV K and V 40 KB +
// two stages of 32 query rows (Q, dO) 40 KB; dQ Q and dO 40 KB + the
// ring 80 KB.  The f32 kernels stage K, Q at pitch D + 1 and V, dO at
// Dv + 1 (145-194 KB, past the default 48 KB: opted in).  Equal head dims
// run as before; (192, 192) is not compiled.
// Copy pipeline.  K/V tiles (forward, dQ) stream through a ring of two
// stages filled by TMA (cp.async.bulk.tensor on a [heads, Sk, D] tensor
// map, one box per swizzled panel, rows past Sk zero-filled) and
// completed on one mbarrier per stage: one thread starts tile j + 1 while
// every warpgroup multiplies tile j; a block barrier at the end of each
// tile frees its stage.  Query-side rows (Q, dO, and the dK/dV kernel's
// query steps, in the same two-stage ring) are gathered by cp.async, 16
// bytes a thread, because a (t, g) tile takes its G rows from G heads;
// a proxy fence makes them visible to wgmma.  The output goes back
// through the block's own shared rows so that global stores are 16 bytes
// a lane.  Not yet: a producer warp with the consumers' registers raised
// by setmaxnreg, and overlap of one tile's softmax with the next tile's
// products.
// Numerics: S, the softcap's tanh, the running max m and sum l, lse,
// delta and every accumulator are f32.  The softmax scale multiplies S in
// f32 after the product (never rounded into q; any sm_scale), together
// with log2(e): scores are kept in log2 units, so p = exp2(s - m) costs
// one subtraction and one ex2 per entry.  bf16 rounding enters at the
// operands (the inputs are bf16), at P before the P V product, at P and
// dS before the dV, dK and dQ products (as FlashAttention-2/3 do), and
// at the outputs, but never at O where delta reads it: a row's dS =
// P (dP - delta) sums to zero over its columns only if delta =
// rowsum(dO O) is sum_k P_k dP_k, and where the K rows share a large
// common component -- a cross-attention's K from an encoder whose
// near-uniform attention adds one vector to every position -- the
// residue that O's rounding leaves, times that component, can dwarf dQ
// and the weight gradients after it (seamless's cross-attention wq and
// wk gradients 5.9x further from f32 than the plain bf16 path's, NVIDIA
// H100 80GB HBM3, 700 W).  So training's forward (kKeepF32) also writes
// O in f32 before its rounding, and delta reads that.  P's rounding is unbiased with a
// relative error of at most 2^-9 per entry, so a row that spreads its
// weight over n columns gains an error of about 2^-9 |v| / sqrt(n) in o,
// under the one bf16 ulp (2^-8 relative) of the output's own rounding;
// l sums the unrounded f32 p.
//
// f32 keeps the FMA kernels (256 threads as 16 x 16, a 4 x 4 register tile
// each, f32 tiles staged with a pitch of D + 1), chosen by dtype in the
// launchers: a TF32 tensor-core product keeps ~3 decimal digits and would
// break the f32 tests' 2e-5.  It is an explicit dispatch: a bf16 tensor
// always takes the tensor-core kernels.
//
// Common to both: GQA by index, never by repeating K/V.  A query tile
// holds rows r = t * G + g -- the G = Hq / Hkv q heads of one kv head at
// consecutive positions t -- so the G heads share each K/V tile and the
// causal limit of a row depends only on t (any G: 5, 9, 48 ...).  Causal
// masking uses the oracle's offset: query t sees columns <= t + (Sk - Sq)
// (the Pallas kernel uses the diagonal, the same for Sq == Sk).  Causal
// skipping is at tile granularity: a block streams only the K/V tiles up
// to its own largest visible column, and the dK/dV block only the query
// tiles that see its columns; inside a tile every masked entry gets
// p = 0 explicitly (bf16: only in tiles that some row does not see
// whole; the others skip the compares).  S needs no tile multiple: the
// ragged tail is masked.  A row that sees no column writes zeros and
// lse = -1e30, as the Pallas kernel writes zeros.  Blocks are ordered
// longest first.  The backward is deterministic, with no atomics: a delta
// pre-pass computes rowsum(dO * O); one dK/dV block per (b, kv head, K/V
// tile) loops over every query tile of its G q heads, so dK and dV sum
// over the group in registers; one dQ block per (b, kv head, query tile)
// loops over the K/V tiles and recomputes p from lse.  S and dP are
// computed in both (seven tile products against five): the price of
// having no atomics.
#include "attn_tc.cuh"
#include "common.cuh"
#include "mma.cuh"

namespace {

using rt::kNegInf;

// f32 (FMA) kernels' tiling
constexpr int kThreads = 256;   // 16 x 16, a 4 x 4 register tile each
constexpr int kBQ = 64;         // query rows per tile
constexpr int kBK = 64;         // K/V rows per tile
constexpr int kPP = kBK + 1;    // padded row of a score tile in shared memory

// What every kernel needs to know about the problem.
struct Problem {
  int hkv, G, Sq, Sk;
  int causal;     // 0 / 1
  int offset;     // causal: query t sees columns <= t + offset (Sk - Sq)
  float scale;    // softmax scale: f32 kernels scale q, bf16 kernels S
  float softcap;  // > 0: s = softcap * tanh(s / softcap)
  __host__ __device__ int rows() const { return G * Sq; }
  // the last column row r = (t, g) of a query tile sees (-1: none)
  __device__ int limit(int r) const {
    if (r >= rows()) return -1;
    if (!causal) return Sk - 1;
    const int lim = r / G + offset;
    return lim < Sk - 1 ? lim : Sk - 1;
  }
};

// Element offset of query-tile row r = (t, g) of (b, kv head h) in
// q / o / dq [B, Hq, Sq, D], and of its lse / delta entry [B, Hq, Sq].
__device__ __forceinline__ size_t qrow(const Problem& p, size_t head, int r) {
  return (head * p.G + r % p.G) * static_cast<size_t>(p.Sq) + r / p.G;
}

// Stage `n` rows of a [*, D] tensor (starting at element `base` with row
// stride D, rows past `valid` zero) into shared memory with row pitch D+1,
// times `mul`.  `row_of(i)` maps tile row i to its element row offset.
template <typename T, int D, typename RowOf>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, int valid,
                                      RowOf row_of, float mul) {
  constexpr int V = rt::Vec<T>::n;
  constexpr int DV = D / V;
  for (int i = threadIdx.x; i < kBQ * DV; i += kThreads) {
    const int rr = i / DV, c = (i % DV) * V;
    float t[V];
    if (rr < valid) {
      rt::load_vec(src + row_of(rr) * D + c, t);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) t[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < V; ++j) dst[rr * (D + 1) + c + j] = t[j] * mul;
  }
}

// s[i][j] = a[ty*4+i] . b[tx+16j] over D, both staged with pitch D+1.
template <int D>
__device__ __forceinline__ void dot_tile(const float* a, const float* b, float s[4][4]) {
  constexpr int DP = D + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty * 4 + i) * DP + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * DP + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] += av[i] * bv[j];
  }
}

// The softcap in place: s <- c * tanh(s / c), keeping tanh in th.
__device__ __forceinline__ void softcap(float s[4][4], float th[4][4], float c) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      th[i][j] = c > 0.f ? tanhf(s[i][j] / c) : 0.f;
      if (c > 0.f) s[i][j] = c * th[i][j];
    }
}

// acc[i][c] += sum_j w[row_i][j] * m[j][tx + 16c]: w a 64 x 64 tile with
// pitch kPP (row_i = ty*4+i, or column ty*4+i of w when `transposed`), m a
// 64 x D tile with pitch D+1.
template <int D, bool kTransposed>
__device__ __forceinline__ void tile_mm(const float* w, const float* m, float acc[4][D / 16]) {
  constexpr int NC = D / 16;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 4
  for (int j = 0; j < kBK; ++j) {
    float mv[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) mv[c] = m[j * (D + 1) + tx + 16 * c];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = kTransposed ? w[j * kPP + ty * 4 + i] : w[(ty * 4 + i) * kPP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] += a * mv[c];
    }
  }
}

// ---------------------------------------------------------------- forward ----
// D: q / k head dim; DV: v / o head dim (DV <= D).
template <int D, int DV>
constexpr size_t fwd_smem_floats() {
  return 2 * kBQ * (D + 1) + kBQ * (DV + 1) + kBQ * kPP;   // q, k, v tiles + probabilities
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, Problem pb) {
  constexpr int NC = DV / 16;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kBQ * (D + 1);
  float* v_s = k_s + kBK * (D + 1);
  float* p_s = v_s + kBK * (DV + 1);

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int r0 = tile * kBQ;
  const int nrows = pb.rows() - r0 < kBQ ? pb.rows() - r0 : kBQ;
  const size_t head = static_cast<size_t>(b) * pb.hkv + h;
  const T* kh = k + head * pb.Sk * D;
  const T* vh = v + head * pb.Sk * DV;

  stage<T, D>(q_s, q, nrows, [&](int rr) { return qrow(pb, head, r0 + rr); }, pb.scale);
  // columns any row of this tile may see: [0, limit of its last row]
  const int ncols = pb.limit(r0 + nrows - 1) + 1;

  float m_i[4], l_i[4], acc[4][NC];
  int lim[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lim[i] = pb.limit(r0 + ty * 4 + i);
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int c0 = 0; c0 < ncols; c0 += kBK) {
    const int nk = ncols - c0 < kBK ? ncols - c0 : kBK;
    __syncthreads();   // the previous tile's readers are done
    stage<T, D>(k_s, kh, nk, [&](int rr) { return static_cast<size_t>(c0 + rr); }, 1.f);
    stage<T, DV>(v_s, vh, nk, [&](int rr) { return static_cast<size_t>(c0 + rr); }, 1.f);
    __syncthreads();

    float s[4][4], th[4][4];
    dot_tile<D>(q_s, k_s, s);
    softcap(s, th, pb.softcap);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ok[j] = c0 + tx + 16 * j <= lim[i];
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
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        p_s[(ty * 4 + i) * kPP + tx + 16 * j] = p;
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
    tile_mm<DV, false>(p_s, v_s, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r - r0 >= nrows) continue;
    const size_t row = qrow(pb, head, r);
    const float l = l_i[i];
#pragma unroll
    for (int c = 0; c < NC; ++c)
      o[row * DV + tx + 16 * c] = rt::from_f<T>(l == 0.f ? 0.f : acc[i][c] / l);
    if (tx == 0) lse[row] = l == 0.f ? kNegInf : m_i[i] + logf(l);
  }
}

// --------------------------------------------------------- backward: delta ----
// delta[row] = sum_d dO[row, d] * O[row, d], one thread per row, from O
// in f32: under bf16 the forward's o before its rounding.  A row's dS =
// P (dP - delta) sums to zero over its columns only if delta is
// sum_k P_k dP_k; O rounded to bf16 moves delta by up to ~2^-9 |dO| |O|,
// and that error times the attention-weighted mean of the K rows enters
// every dQ entry (and dK through Q), which can dwarf dQ where the K rows
// share a large common component.
template <typename T, int D>
__global__ void flash_delta_kernel(const float* __restrict__ o, const T* __restrict__ dout,
                                   float* __restrict__ delta, long long rows) {
  constexpr int V = rt::Vec<T>::n;   // 8 bf16 or 4 f32: dO's 16-byte loads
  const long long row = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < D; c += V) {
    float a[V], g[V];
#pragma unroll
    for (int j = 0; j < V; j += 4) rt::load_vec(o + row * D + c + j, a + j);
    rt::load_vec(dout + row * D + c, g);
#pragma unroll
    for (int j = 0; j < V; ++j) sum += a[j] * g[j];
  }
  delta[row] = sum;
}

// Recompute p = exp(s - lse) (0 where masked) and dS = p * (dP - delta)
// (times 1 - tanh^2 under the softcap) for the 4 x 4 tile of this thread:
// rows ty*4+i of the query tile staged in q_s / do_s, columns tx+16j of the
// K/V tile staged in k_s / v_s starting at column c0.  lse_s / delta_s hold
// the query tile's rows; lim[i] is row i's last visible column.
template <int D, int DV>
__device__ __forceinline__ void recompute(const Problem& pb, const float* q_s, const float* do_s,
                                          const float* k_s, const float* v_s,
                                          const float* lse_s, const float* delta_s,
                                          const int lim[4], int c0, float p[4][4],
                                          float ds[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float th[4][4], dp[4][4];
  dot_tile<D>(q_s, k_s, p);
  softcap(p, th, pb.softcap);
  dot_tile<DV>(do_s, v_s, dp);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rr = ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = c0 + tx + 16 * j <= lim[i];
      p[i][j] = ok ? expf(p[i][j] - lse_s[rr]) : 0.f;
      float d = p[i][j] * (dp[i][j] - delta_s[rr]);
      if (pb.softcap > 0.f) d *= 1.f - th[i][j] * th[i][j];
      ds[i][j] = d;
    }
  }
}

// Stage a query tile's q (times scale), dO, lse and delta; returns its rows.
template <typename T, int D, int DV>
__device__ __forceinline__ int stage_queries(const Problem& pb, size_t head, int r0,
                                             const T* __restrict__ q, const T* __restrict__ dout,
                                             const float* __restrict__ lse,
                                             const float* __restrict__ delta, float* q_s,
                                             float* do_s, float* lse_s, float* delta_s) {
  const int nrows = pb.rows() - r0 < kBQ ? pb.rows() - r0 : kBQ;
  auto row_of = [&](int rr) { return qrow(pb, head, r0 + rr); };
  stage<T, D>(q_s, q, nrows, row_of, pb.scale);
  stage<T, DV>(do_s, dout, nrows, row_of, 1.f);
  for (int rr = threadIdx.x; rr < kBQ; rr += kThreads) {
    const bool ok = rr < nrows;
    lse_s[rr] = ok ? lse[row_of(rr)] : 0.f;
    delta_s[rr] = ok ? delta[row_of(rr)] : 0.f;
  }
  return nrows;
}

// --------------------------------------------------------- backward: dK/dV ----
template <int D, int DV>
constexpr size_t dkdv_smem_floats() {   // k, v, q, dO; p, dS; lse, delta
  return 2 * kBQ * (D + 1) + 2 * kBQ * (DV + 1) + 2 * kBQ * kPP + 2 * kBQ;
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      Problem pb) {
  constexpr int NC = D / 16, NV = DV / 16;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + kBK * (D + 1);
  float* q_s = v_s + kBK * (DV + 1);
  float* do_s = q_s + kBQ * (D + 1);
  float* p_s = do_s + kBQ * (DV + 1);
  float* ds_s = p_s + kBQ * kPP;
  float* lse_s = ds_s + kBQ * kPP;
  float* delta_s = lse_s + kBQ;

  const int c0 = blockIdx.x * kBK, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nk = pb.Sk - c0 < kBK ? pb.Sk - c0 : kBK;
  const size_t head = static_cast<size_t>(b) * pb.hkv + h;
  const T* kh = k + head * pb.Sk * D;
  const T* vh = v + head * pb.Sk * DV;
  stage<T, D>(k_s, kh, nk, [&](int rr) { return static_cast<size_t>(c0 + rr); }, 1.f);
  stage<T, DV>(v_s, vh, nk, [&](int rr) { return static_cast<size_t>(c0 + rr); }, 1.f);

  float dk_acc[4][NC], dv_acc[4][NV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[i][c] = 0.f;
#pragma unroll
    for (int c = 0; c < NV; ++c) dv_acc[i][c] = 0.f;
  }

  // causal: the first query position that sees column c0 is c0 - offset
  int t_first = pb.causal ? c0 - pb.offset : 0;
  t_first = t_first < 0 ? 0 : t_first;
  const int rows = pb.rows();
  for (int r0 = (t_first * pb.G) / kBQ * kBQ; r0 < rows; r0 += kBQ) {
    __syncthreads();   // the previous tile's readers are done
    stage_queries<T, D, DV>(pb, head, r0, q, dout, lse, delta, q_s, do_s, lse_s, delta_s);
    __syncthreads();
    int lim[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) lim[i] = pb.limit(r0 + ty * 4 + i);
    float p[4][4], ds[4][4];
    recompute<D, DV>(pb, q_s, do_s, k_s, v_s, lse_s, delta_s, lim, c0, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p_s[(ty * 4 + i) * kPP + tx + 16 * j] = p[i][j];
        ds_s[(ty * 4 + i) * kPP + tx + 16 * j] = ds[i][j];
      }
    __syncthreads();
    // this thread's K/V rows are ty*4+i: dV += P^T dO, dK += dS^T (q*scale)
    tile_mm<DV, true>(p_s, do_s, dv_acc);
    tile_mm<D, true>(ds_s, q_s, dk_acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = ty * 4 + i;
    if (kr >= nk) continue;
    const size_t row = head * pb.Sk + c0 + kr;
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[row * D + tx + 16 * c] = rt::from_f<T>(dk_acc[i][c]);
#pragma unroll
    for (int c = 0; c < NV; ++c) dv[row * DV + tx + 16 * c] = rt::from_f<T>(dv_acc[i][c]);
  }
}

// ------------------------------------------------------------ backward: dQ ----
template <int D, int DV>
constexpr size_t dq_smem_floats() {   // q, dO, k, v; dS; lse, delta
  return 2 * kBQ * (D + 1) + 2 * kBQ * (DV + 1) + kBQ * kPP + 2 * kBQ;
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, Problem pb) {
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + kBQ * (D + 1);
  float* k_s = do_s + kBQ * (DV + 1);
  float* v_s = k_s + kBK * (D + 1);
  float* ds_s = v_s + kBK * (DV + 1);
  float* lse_s = ds_s + kBQ * kPP;
  float* delta_s = lse_s + kBQ;

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int r0 = tile * kBQ;
  const size_t head = static_cast<size_t>(b) * pb.hkv + h;
  const T* kh = k + head * pb.Sk * D;
  const T* vh = v + head * pb.Sk * DV;
  const int nrows =
      stage_queries<T, D, DV>(pb, head, r0, q, dout, lse, delta, q_s, do_s, lse_s, delta_s);
  const int ncols = pb.limit(r0 + nrows - 1) + 1;

  float acc[4][NC];
  int lim[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lim[i] = pb.limit(r0 + ty * 4 + i);
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int c0 = 0; c0 < ncols; c0 += kBK) {
    const int nk = ncols - c0 < kBK ? ncols - c0 : kBK;
    __syncthreads();   // the previous tile's readers are done
    stage<T, D>(k_s, kh, nk, [&](int rr) { return static_cast<size_t>(c0 + rr); }, 1.f);
    stage<T, DV>(v_s, vh, nk, [&](int rr) { return static_cast<size_t>(c0 + rr); }, 1.f);
    __syncthreads();
    float p[4][4], ds[4][4];
    recompute<D, DV>(pb, q_s, do_s, k_s, v_s, lse_s, delta_s, lim, c0, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ds_s[(ty * 4 + i) * kPP + tx + 16 * j] = ds[i][j];
    __syncthreads();
    tile_mm<D, false>(ds_s, k_s, acc);   // dQ += dS K
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r - r0 >= nrows) continue;
    const size_t row = qrow(pb, head, r) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) dq[row + tx + 16 * c] = rt::from_f<T>(acc[i][c] * pb.scale);
  }
}

}  // namespace

// ====================================================== bf16: tensor cores ====
// Tiles, descriptors, product issue, the K/V ring and the online softmax
// are shared with the chunk kernels (attn_tc.cuh).
namespace tc {

constexpr int kFwdWarps = 8;               // forward block: 8 warps
constexpr int kFwdM = 16 * kFwdWarps;      // query rows per forward block
constexpr int kBwdWarps = 4;               // dK/dV and dQ blocks: 4 warps
constexpr int kBwdM = 16 * kBwdWarps;      // K/V rows per dK/dV block, q rows per dQ block

// q rows per step of the dK/dV loop: 32 at tile widths 128 and 192 (D 80,
// 128, 192) keeps the four accumulator tiles (dK, dV, S^T, dP^T) in
// registers.  At (192, 128) ptxas gives 255 registers and spills 8 bytes;
// a 16-row step spills nothing but ran slower on the card (its S^T and
// dP^T products at n 16, twice the steps and barriers).
template <int D>
__host__ __device__ constexpr int dkdv_q() { return tile_dim<D>() <= 64 ? 64 : 32; }

// A product's entry s as a score in log2 units, in place: s * scale *
// log2(e), or under the softcap c * tanh(s * scale / c) * log2(e), so that
// p = exp2(s - m) with m in the same units.  Returns the softcap's chain
// factor 1 - tanh^2 (1 without one).
struct Score {
  float mul;   // scale * log2(e), or scale / c under the softcap
  float cap;   // c * log2(e), or 0: no softcap
  __device__ explicit Score(const Problem& pb)
      : mul(pb.softcap > 0.f ? pb.scale / pb.softcap : pb.scale * kLog2e),
        cap(pb.softcap > 0.f ? pb.softcap * kLog2e : 0.f) {}
  __device__ __forceinline__ float operator()(float& s) const {
    if (cap == 0.f) {
      s *= mul;
      return 1.f;
    }
    const float th = tanhf(s * mul);
    s = cap * th;
    return 1.f - th * th;
  }
};

// The backward's p and dS from a score tile and its dP tile (D layout),
// in place: s becomes p = exp2(score - lse log2(e)), dp becomes
// dS = p (dP - delta) times the softcap's factor.  Entry (n, e) has q row
// qr(n, e) (lse, delta and last visible column from row_of(qr)) and
// column col(n, e); under kMask the entries past a row's last visible
// column get p = 0.
template <bool kMask, int NS, typename QRow, typename Col, typename RowOf>
__device__ __forceinline__ void grad_tile(float (&s)[NS][4], float (&dp)[NS][4], QRow qr, Col col,
                                          RowOf row_of, const Score& score) {
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float lb, dl;
      int lim;
      row_of(qr(n, e), lb, dl, lim);
      const float dcap = score(s[n][e]);
      const float p = !kMask || col(n, e) <= lim ? exp2f(s[n][e] - lb) : 0.f;
      s[n][e] = p;
      dp[n][e] = p * (dp[n][e] - dl) * dcap;
    }
}

// ---------------------------------------------------------------- forward ----
// D: q / k head dim; DV: v / o head dim (DV <= D).  The ring holds K at
// D's tile width and V at DV's.
template <int D, int DV>
using FlashRing = KvRing<tile_dim<D>(), 2, kBN, tile_dim<DV>()>;

template <int D, int DV>
constexpr size_t fwd_smem() {   // Q tile + the K/V ring
  return kFwdM * tile_dim<D>() * sizeof(bf16) + FlashRing<D, DV>::kBytes + kAlign;
}

// kKeepF32 (training, o32 given): o is also stored in f32 before its
// rounding, for the backward's delta (see Numerics).
template <int D, int DV, bool kKeepF32>
__global__ void __launch_bounds__(kFwdWarps * 32, tile_dim<D>() <= 64 ? 2 : 1)
fwd_kernel(const bf16* __restrict__ q, const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
           float* __restrict__ o32, float* __restrict__ lse, Problem pb) {
  constexpr int NT = kFwdWarps * 32, NS = kBN / 8, DT = tile_dim<D>(), DVT = tile_dim<DV>();
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(aligned_smem(tc_smem));
  const FlashRing<D, DV> ring(q_s + kFwdM * DT);

  const int head = blockIdx.x;                             // b * hkv + h
  const int r0 = (gridDim.y - 1 - blockIdx.y) * kFwdM;     // longest tiles first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nrows = min(pb.rows() - r0, kFwdM);
  auto q_of = [&](int rr) { return qrow(pb, head, r0 + rr); };
  const int ncols = max(pb.limit(r0 + nrows - 1) + 1, 0);   // columns any row sees
  const int ntiles = (ncols + kBN - 1) / kBN;

  if (threadIdx.x == 0) {
    ring.init();
    if (ntiles > 0) ring.load(&tk, &tv, head, 0);
  }
  load_rows<DT, kFwdM, NT, D>(q_s, q, nrows, q_of);
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  mma::fence_async_smem();
  __syncthreads();   // Q has landed, the ring's barriers are set

  const int rw = warp * 16 + (lane >> 2);   // this thread's rows: rw, rw + 8
  const int lim[2] = {pb.limit(r0 + rw), pb.limit(r0 + rw + 8)};
  // the tile's first row sees the fewest columns; rows past the last
  // valid one may go unmasked: their zero Q gives finite p, never stored
  const int lim_lo = pb.limit(r0);
  const Score score(pb);
  float acc[DVT / 8][4] = {};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // m in log2 units

  for (int j = 0; j < ntiles; ++j) {
    if (threadIdx.x == 0 && j + 1 < ntiles) ring.load(&tk, &tv, head, j + 1);
    ring.wait(j);
    const bf16* k_s = ring.k(j);

    float s[NS][4] = {}, alpha[2];
    mma::fence_regs(s);
    mma::wgmma_fence();
    issue_abt<DT, kFwdM, D>(s, q_s, (warp >> 2) * 64, k_s);   // S = Q K^T, this warpgroup's rows
    mma::wgmma_commit();
    mma::wgmma_wait<0>();
    mma::fence_regs(s);
    const int cb = j * kBN + (lane & 3) * 2;
    if ((j + 1) * kBN - 1 <= lim_lo)   // every row sees the whole tile
      online_softmax<false>(s, m, l, alpha, cb, lim, score);
    else
      online_softmax<true>(s, m, l, alpha, cb, lim, score);
#pragma unroll
    for (int n = 0; n < DVT / 8; ++n) {
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
    issue_pb<DVT>(acc, pa, ring.v(j));   // O += P V
    mma::wgmma_commit();
    mma::wgmma_wait<0>();
    mma::fence_regs(acc);
    __syncthreads();   // stage j & 1 is refilled next iteration
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = l[i] == 0.f ? 0.f : 1.f / l[i];
  }
  // the warp's own Q rows, as a [kFwdM, DVT] tile
  acc_to_tile<DVT, kFwdM>(q_s, warp * 16, acc, inv[0], inv[1]);
  __syncwarp();
  store_rows<DVT, kFwdM, DV>(q_s, o, warp * 16, nrows, q_of);
  if constexpr (kKeepF32) {   // o before its rounding, for the backward's delta
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (rw + 8 * i >= nrows) continue;
      float* dst = o32 + q_of(rw + 8 * i) * DV;
#pragma unroll
      for (int n = 0; n < DVT / 8; ++n) {
        const int c = n * 8 + (lane & 3) * 2;
        if (c < DV)
          *reinterpret_cast<float2*>(dst + c) =
              make_float2(acc[n][2 * i] * inv[i], acc[n][2 * i + 1] * inv[i]);
      }
    }
  }
  if ((lane & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (rw + 8 * i < nrows)
        lse[q_of(rw + 8 * i)] = l[i] == 0.f ? kNegInf : (m[i] + log2f(l[i])) / kLog2e;
  }
}

// --------------------------------------------------------- backward: dK/dV ----
template <int D, int DV>
constexpr size_t dkdv_smem() {   // K, V; two stages of (Q, dO, lse, delta, limit)
  constexpr int W = tile_dim<D>() + tile_dim<DV>();
  return kBwdM * W * sizeof(bf16) + 2 * dkdv_q<D>() * (W * sizeof(bf16) + 12) + kAlign;
}

template <int D, int DV>
__global__ void __launch_bounds__(kBwdWarps * 32)
dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
            const bf16* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
            Problem pb) {
  constexpr int DT = tile_dim<D>(), DVT = tile_dim<DV>();
  constexpr int NT = kBwdWarps * 32, BQ = dkdv_q<D>(), NS = BQ / 8, ST = BQ * (DT + DVT);
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* k_s = reinterpret_cast<bf16*>(aligned_smem(tc_smem));
  bf16* v_s = k_s + kBwdM * DT;
  bf16* qd_s = v_s + kBwdM * DVT;   // stage s: Q at qd_s + s ST, dO after it
  float* lse_s = reinterpret_cast<float*>(qd_s + 2 * ST);   // [2][BQ]
  float* delta_s = lse_s + 2 * BQ;
  int* lim_s = reinterpret_cast<int*>(delta_s + 2 * BQ);

  const size_t head = blockIdx.x;
  const int c0 = blockIdx.y * kBwdM;   // causal: the first K/V tiles are the longest
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nk = min(pb.Sk - c0, kBwdM);
  auto kv_of = [&](int rr) { return head * pb.Sk + c0 + rr; };
  load_rows<DT, kBwdM, NT, D>(k_s, k, nk, kv_of);
  load_rows<DVT, kBwdM, NT, DV>(v_s, v, nk, kv_of);

  // causal: the first query position that sees column c0 is c0 - offset
  const int t_first = pb.causal ? max(c0 - pb.offset, 0) : 0;
  const int rows = pb.rows();
  const int first = static_cast<int>(min(static_cast<long long>(t_first) * pb.G,
                                         static_cast<long long>(rows)) / BQ);
  const int ntiles = (rows + BQ - 1) / BQ - first;
  auto load_q = [&](int i) {
    const int s = i & 1, rq = (first + i) * BQ, n = min(rows - rq, BQ);
    auto q_of = [&](int rr) { return qrow(pb, head, rq + rr); };
    load_rows<DT, BQ, NT, D>(qd_s + s * ST, q, n, q_of);
    load_rows<DVT, BQ, NT, DV>(qd_s + s * ST + BQ * DT, dout, n, q_of);
    for (int rr = threadIdx.x; rr < BQ; rr += NT) {
      const bool ok = rr < n;
      mma::cp_async4(lse_s + s * BQ + rr, ok ? lse + q_of(rr) : lse, ok);
      mma::cp_async4(delta_s + s * BQ + rr, ok ? delta + q_of(rr) : delta, ok);
      lim_s[s * BQ + rr] = pb.limit(rq + rr);   // -1 past the last row
    }
  };
  if (ntiles > 0) load_q(0);
  mma::cp_async_commit();   // with K and V

  const int kr = warp * 16;                        // the warp's K/V rows
  const int kc = c0 + kr + (lane >> 2);            // this thread's columns: kc, kc + 8
  const Score score(pb);
  float dka[DT / 8][4] = {}, dva[DVT / 8][4] = {};
  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) load_q(i + 1);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();
    mma::fence_async_smem();
    __syncthreads();
    const int s = i & 1;
    const bf16* q_s = qd_s + s * ST;
    const bf16* do_s = q_s + BQ * DT;

    float st[NS][4] = {}, dpt[NS][4] = {};   // S^T, dP^T: K/V rows x q rows
    mma::fence_regs(st);
    mma::fence_regs(dpt);
    mma::wgmma_fence();
    issue_abt<DT, kBwdM, D>(st, k_s, 0, q_s);
    issue_abt<DVT, kBwdM, DV>(dpt, v_s, 0, do_s);
    mma::wgmma_commit();
    mma::wgmma_wait<0>();
    mma::fence_regs(st);
    mma::fence_regs(dpt);
    // entry (n, e): q row n*8 + 2(lane % 4) + e % 2 of the tile, column kc + 8(e / 2)
    auto qr = [&](int n, int e) { return s * BQ + n * 8 + (lane & 3) * 2 + (e & 1); };
    auto col = [&](int n, int e) { return kc + 8 * (e >> 1); };
    auto row_of = [&](int r, float& lb, float& dl, int& lim) {
      lb = lse_s[r] * kLog2e;
      dl = delta_s[r];
      lim = lim_s[r];
    };
    // the tile's first row sees the fewest columns (see the forward)
    if (c0 + kBwdM - 1 <= lim_s[s * BQ])
      grad_tile<false>(st, dpt, qr, col, row_of, score);
    else
      grad_tile<true>(st, dpt, qr, col, row_of, score);
    uint32_t pa[NS / 2][4], da[NS / 2][4];
    mma::to_a<NS>(pa, st);
    mma::to_a<NS>(da, dpt);
    mma::fence_regs(dva);
    mma::fence_regs(dka);
    mma::fence_regs(pa);
    mma::fence_regs(da);
    mma::wgmma_fence();
    issue_pb<DVT>(dva, pa, do_s);   // dV += P^T dO
    issue_pb<DT>(dka, da, q_s);    // dK += dS^T Q
    mma::wgmma_commit();
    mma::wgmma_wait<0>();
    mma::fence_regs(dva);
    mma::fence_regs(dka);
    __syncthreads();
  }

  mma::cp_async_wait<0>();
  __syncthreads();
  acc_to_tile<DT, kBwdM>(k_s, kr, dka, pb.scale, pb.scale);   // dK takes the scale once
  acc_to_tile<DVT, kBwdM>(v_s, kr, dva, 1.f, 1.f);
  __syncwarp();
  store_rows<DT, kBwdM, D>(k_s, dk, kr, nk, kv_of);
  store_rows<DVT, kBwdM, DV>(v_s, dv, kr, nk, kv_of);
}

// ------------------------------------------------------------ backward: dQ ----
template <int D, int DV>
constexpr size_t dq_smem() {   // Q, dO; the K/V ring
  return kBwdM * (tile_dim<D>() + tile_dim<DV>()) * sizeof(bf16) + FlashRing<D, DV>::kBytes +
         kAlign;
}

template <int D, int DV>
__global__ void __launch_bounds__(kBwdWarps * 32)
dq_kernel(const bf16* __restrict__ q, const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv, const bf16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          bf16* __restrict__ dq, Problem pb) {
  constexpr int NT = kBwdWarps * 32, NS = kBN / 8, DT = tile_dim<D>(), DVT = tile_dim<DV>();
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(aligned_smem(tc_smem));
  bf16* do_s = q_s + kBwdM * DT;
  const FlashRing<D, DV> ring(do_s + kBwdM * DVT);

  const int head = blockIdx.x;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * kBwdM;   // longest tiles first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nrows = min(pb.rows() - r0, kBwdM);
  auto q_of = [&](int rr) { return qrow(pb, head, r0 + rr); };
  const int ncols = max(pb.limit(r0 + nrows - 1) + 1, 0);
  const int ntiles = (ncols + kBN - 1) / kBN;

  if (threadIdx.x == 0) {
    ring.init();
    if (ntiles > 0) ring.load(&tk, &tv, head, 0);
  }
  load_rows<DT, kBwdM, NT, D>(q_s, q, nrows, q_of);
  load_rows<DVT, kBwdM, NT, DV>(do_s, dout, nrows, q_of);
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  mma::fence_async_smem();
  __syncthreads();   // Q and dO have landed, the ring's barriers are set

  const int rw = warp * 16 + (lane >> 2);   // this thread's rows: rw, rw + 8
  int lim[2];
  float lb[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rr = rw + 8 * i;
    lim[i] = pb.limit(r0 + rr);
    lb[i] = rr < nrows ? lse[q_of(rr)] * kLog2e : 0.f;
    dl[i] = rr < nrows ? delta[q_of(rr)] : 0.f;
  }
  const int lim_lo = pb.limit(r0);   // as in the forward
  const Score score(pb);
  float acc[DT / 8][4] = {};
  for (int j = 0; j < ntiles; ++j) {
    if (threadIdx.x == 0 && j + 1 < ntiles) ring.load(&tk, &tv, head, j + 1);
    ring.wait(j);
    const bf16* k_s = ring.k(j);

    float s[NS][4] = {}, dp[NS][4] = {};
    mma::fence_regs(s);
    mma::fence_regs(dp);
    mma::wgmma_fence();
    issue_abt<DT, kBwdM, D>(s, q_s, 0, k_s);
    issue_abt<DVT, kBwdM, DV>(dp, do_s, 0, ring.v(j));
    mma::wgmma_commit();
    mma::wgmma_wait<0>();
    mma::fence_regs(s);
    mma::fence_regs(dp);
    const int cb = j * kBN + (lane & 3) * 2;
    // entry (n, e): this thread's row e / 2, column cb + 8n + e % 2
    auto qr = [&](int n, int e) { return e >> 1; };
    auto col = [&](int n, int e) { return cb + n * 8 + (e & 1); };
    auto row_of = [&](int i, float& lbi, float& dli, int& limi) {
      lbi = lb[i];
      dli = dl[i];
      limi = lim[i];
    };
    if ((j + 1) * kBN - 1 <= lim_lo)
      grad_tile<false>(s, dp, qr, col, row_of, score);
    else
      grad_tile<true>(s, dp, qr, col, row_of, score);
    uint32_t pa[NS / 2][4];
    mma::to_a<NS>(pa, dp);   // dS
    mma::fence_regs(acc);
    mma::fence_regs(pa);
    mma::wgmma_fence();
    issue_pb<DT>(acc, pa, k_s);   // dQ += dS K
    mma::wgmma_commit();
    mma::wgmma_wait<0>();
    mma::fence_regs(acc);
    __syncthreads();
  }

  __syncthreads();
  acc_to_tile<DT, kBwdM>(q_s, warp * 16, acc, pb.scale, pb.scale);
  __syncwarp();
  store_rows<DT, kBwdM, D>(q_s, dq, warp * 16, nrows, q_of);
}

}  // namespace tc

namespace {

// ----------------------------------------------------------------- launch ----
bool valid(int B, int hkv, int G, int Sq, int Sk) {
  return B > 0 && hkv > 0 && G > 0 && Sq > 0 && Sk > 0;
}

Problem make_problem(int hkv, int G, int Sq, int Sk, int causal, float scale, float softcap) {
  return Problem{hkv, G, Sq, Sk, causal ? 1 : 0, Sk - Sq, scale, softcap};
}

// Opt `kernel` into `bytes` of dynamic shared memory and launch it.
template <typename K, typename... Args>
cudaError_t launch(K kernel, const cudaError_t& attr, dim3 grid, int threads, size_t bytes,
                   cudaStream_t s, Args... args) {
  if (attr != cudaSuccess) return attr;
  kernel<<<grid, threads, bytes, s>>>(args...);
  return cudaGetLastError();
}

// f32: the FMA kernels
template <int D, int DV>
cudaError_t fwd_f32(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                    const Problem& pb, cudaStream_t s) {
  constexpr size_t smem = fwd_smem_floats<D, DV>() * sizeof(float);
  auto kernel = flash_fwd_kernel<float, D, DV>;
  static const cudaError_t attr = rt::set_smem(kernel, smem);   // once per process
  return launch(kernel, attr, dim3((pb.rows() + kBQ - 1) / kBQ, pb.hkv, B), kThreads, smem, s,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<float*>(o), lse, pb);
}

template <int D, int DV>
cudaError_t bwd_f32(const float* q, const float* k, const float* v, const float* dout,
                    const float* lse, const float* delta, float* dq, float* dk, float* dv, int B,
                    const Problem& pb, cudaStream_t s) {
  constexpr size_t smem_kv = dkdv_smem_floats<D, DV>() * sizeof(float);
  auto kv_kernel = flash_bwd_dkdv_kernel<float, D, DV>;
  static const cudaError_t attr_kv = rt::set_smem(kv_kernel, smem_kv);
  cudaError_t err = launch(kv_kernel, attr_kv, dim3((pb.Sk + kBK - 1) / kBK, pb.hkv, B),
                           kThreads, smem_kv, s, q, k, v, dout, lse, delta, dk, dv, pb);
  if (err != cudaSuccess) return err;
  constexpr size_t smem_q = dq_smem_floats<D, DV>() * sizeof(float);
  auto q_kernel = flash_bwd_dq_kernel<float, D, DV>;
  static const cudaError_t attr_q = rt::set_smem(q_kernel, smem_q);
  return launch(q_kernel, attr_q, dim3((pb.rows() + kBQ - 1) / kBQ, pb.hkv, B), kThreads,
                smem_q, s, q, k, v, dout, lse, delta, dq, pb);
}

// bf16: the tensor-core kernels.  Grid x: (b, kv head); y: tiles, which
// each kernel walks longest first.
template <int D, int DV>
cudaError_t fwd_bf16(const void* q, const void* k, const void* v, void* o, float* o32,
                     float* lse, int B, const Problem& pb, cudaStream_t s) {
  using tc::bf16;
  CUtensorMap tk, tv;
  const cudaError_t err =
      tc::kv_maps<tc::tile_dim<D>(), tc::tile_dim<DV>()>(&tk, &tv, k, v, B * pb.hkv, pb.Sk, D, DV);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = tc::fwd_smem<D, DV>();
  auto kernel = tc::fwd_kernel<D, DV, false>;
  auto keep = tc::fwd_kernel<D, DV, true>;
  static const cudaError_t attr = rt::set_smem(kernel, smem);
  static const cudaError_t attr_keep = rt::set_smem(keep, smem);
  return launch(o32 != nullptr ? keep : kernel, o32 != nullptr ? attr_keep : attr,
                dim3(B * pb.hkv, (pb.rows() + tc::kFwdM - 1) / tc::kFwdM),
                tc::kFwdWarps * 32, smem, s, static_cast<const bf16*>(q), tk, tv,
                static_cast<bf16*>(o), o32, lse, pb);
}

template <int D, int DV>
cudaError_t bwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                     const __nv_bfloat16* dout, const float* lse, const float* delta,
                     __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv, int B,
                     const Problem& pb, cudaStream_t s) {
  constexpr size_t smem_kv = tc::dkdv_smem<D, DV>();
  auto kv_kernel = tc::dkdv_kernel<D, DV>;
  static const cudaError_t attr_kv = rt::set_smem(kv_kernel, smem_kv);
  cudaError_t err = launch(kv_kernel, attr_kv,
                           dim3(B * pb.hkv, (pb.Sk + tc::kBwdM - 1) / tc::kBwdM),
                           tc::kBwdWarps * 32, smem_kv, s, q, k, v, dout, lse, delta, dk, dv, pb);
  if (err != cudaSuccess) return err;
  CUtensorMap tk, tv;
  err = tc::kv_maps<tc::tile_dim<D>(), tc::tile_dim<DV>()>(&tk, &tv, k, v, B * pb.hkv, pb.Sk, D,
                                                           DV);
  if (err != cudaSuccess) return err;
  constexpr size_t smem_q = tc::dq_smem<D, DV>();
  auto q_kernel = tc::dq_kernel<D, DV>;
  static const cudaError_t attr_q = rt::set_smem(q_kernel, smem_q);
  return launch(q_kernel, attr_q, dim3(B * pb.hkv, (pb.rows() + tc::kBwdM - 1) / tc::kBwdM),
                tc::kBwdWarps * 32, smem_q, s, q, tk, tv, dout, lse, delta, dq, pb);
}

template <int D, int DV = D>
cudaError_t fwd_t(int dtype, const void* q, const void* k, const void* v, void* o, float* o32,
                  float* lse, int B, const Problem& pb, cudaStream_t s) {
  switch (dtype) {
    case rt::kBF16: return fwd_bf16<D, DV>(q, k, v, o, o32, lse, B, pb, s);
    case rt::kF32: return fwd_f32<D, DV>(q, k, v, o, lse, B, pb, s);
    default: return cudaErrorInvalidValue;
  }
}

// The delta pre-pass (over o's DV columns, o in f32), then dK/dV and dQ.
template <typename T, int DV, typename Bwd>
cudaError_t bwd_typed(Bwd bwd, const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const float* lse, float* delta, void* dq, void* dk,
                      void* dv, int B, const Problem& pb, cudaStream_t s) {
  const long long rows = static_cast<long long>(B) * pb.hkv * pb.rows();
  flash_delta_kernel<T, DV><<<static_cast<unsigned>((rows + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(o), static_cast<const T*>(dout), delta, rows);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return bwd(static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
             static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), static_cast<T*>(dk),
             static_cast<T*>(dv), B, pb, s);
}

template <int D, int DV = D>
cudaError_t bwd_t(int dtype, const void* q, const void* k, const void* v, const void* o,
                  const void* dout, const float* lse, float* delta, void* dq, void* dk, void* dv,
                  int B, const Problem& pb, cudaStream_t s) {
  switch (dtype) {
    case rt::kBF16:
      return bwd_typed<__nv_bfloat16, DV>(bwd_bf16<D, DV>, q, k, v, o, dout, lse, delta, dq, dk,
                                          dv, B, pb, s);
    case rt::kF32:
      return bwd_typed<float, DV>(bwd_f32<D, DV>, q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                                  pb, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: [B, hkv*G, Sq, D]; k: [B, hkv, Sk, D]; v: [B, hkv, Sk, Dv];
// o: [B, hkv*G, Sq, Dv]; o32: null, or (bf16) o before its rounding in
// f32, like o; lse: [B, hkv*G, Sq] f32.  Head dims (D, Dv):
// (32, 32), (64, 64), (80, 80), (128, 128) and MLA's (192, 128).
// causal: query t sees columns <= t + Sk - Sq.  softcap <= 0: none.
// bf16 runs on the tensor cores, f32 on the FMA pipes.  Returns the
// launch's CUDA error.
extern "C" int flash_attention_fwd_launch(const void* q, const void* k, const void* v, void* o,
                                          void* o32, void* lse, int B, int hkv, int G, int Sq,
                                          int Sk, int D, int Dv, int causal, float scale,
                                          float softcap, int dtype, void* stream) {
  if (!valid(B, hkv, G, Sq, Sk)) return cudaSuccess;
  const Problem pb = make_problem(hkv, G, Sq, Sk, causal, scale, softcap);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  float* of = static_cast<float*>(o32);
  if (D == 192 && Dv == 128) return fwd_t<192, 128>(dtype, q, k, v, o, of, l, B, pb, s);
  if (Dv != D) return cudaErrorInvalidValue;
  switch (D) {
    case 32: return fwd_t<32>(dtype, q, k, v, o, of, l, B, pb, s);
    case 64: return fwd_t<64>(dtype, q, k, v, o, of, l, B, pb, s);
    case 80: return fwd_t<80>(dtype, q, k, v, o, of, l, B, pb, s);
    case 128: return fwd_t<128>(dtype, q, k, v, o, of, l, B, pb, s);
    default: return cudaErrorInvalidValue;
  }
}

// The backward of flash_attention_fwd_launch from its inputs, o in f32
// (under bf16 its o32) and lse: dout like the forward's o; dq like q; dk
// like k; dv like v; delta: f32 scratch of
// B*hkv*G*Sq values.  Three launches on `stream`: the delta pre-pass,
// dK/dV, dQ.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* lse, const void* dout,
                                          void* delta, void* dq, void* dk, void* dv, int B,
                                          int hkv, int G, int Sq, int Sk, int D, int Dv,
                                          int causal, float scale, float softcap, int dtype,
                                          void* stream) {
  if (!valid(B, hkv, G, Sq, Sk)) return cudaSuccess;
  const Problem pb = make_problem(hkv, G, Sq, Sk, causal, scale, softcap);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (D == 192 && Dv == 128)
    return bwd_t<192, 128>(dtype, q, k, v, o, dout, l, dl, dq, dk, dv, B, pb, s);
  if (Dv != D) return cudaErrorInvalidValue;
  switch (D) {
    case 32: return bwd_t<32>(dtype, q, k, v, o, dout, l, dl, dq, dk, dv, B, pb, s);
    case 64: return bwd_t<64>(dtype, q, k, v, o, dout, l, dl, dq, dk, dv, B, pb, s);
    case 80: return bwd_t<80>(dtype, q, k, v, o, dout, l, dl, dq, dk, dv, B, pb, s);
    case 128: return bwd_t<128>(dtype, q, k, v, o, dout, l, dl, dq, dk, dv, B, pb, s);
    default: return cudaErrorInvalidValue;
  }
}
