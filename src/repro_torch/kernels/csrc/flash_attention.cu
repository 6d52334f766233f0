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
//     at D = 128, for registers).  The products are transposed so that
//     kv rows are the M dimension: S^T = K Q^T, dP^T = V dO^T, then
//     dS^T = P^T o (dP^T - delta), dV += P^T dO, dK += dS^T Q; lse, delta
//     and each query row's last visible column are staged in shared
//     memory beside Q and dO.
//   - dQ: 1 warpgroup, a 64-row query tile, K/V tiles of 64 rows: S = Q K^T,
//     dP = dO V^T, dQ += dS K.
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
// operands (the inputs are bf16), at P before the P V product (as
// FlashAttention-2/3 do), at P and dS before the dV, dK and dQ
// products, and at the outputs.  P's rounding is unbiased with a
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
#include <utility>

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
template <int D>
constexpr size_t fwd_smem_floats() {
  return 3 * kBQ * (D + 1) + kBQ * kPP;   // q, k, v tiles + probabilities
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, Problem pb) {
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kBQ * (D + 1);
  float* v_s = k_s + kBK * (D + 1);
  float* p_s = v_s + kBK * (D + 1);

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int r0 = tile * kBQ;
  const int nrows = pb.rows() - r0 < kBQ ? pb.rows() - r0 : kBQ;
  const size_t head = static_cast<size_t>(b) * pb.hkv + h;
  const T* kh = k + head * pb.Sk * D;
  const T* vh = v + head * pb.Sk * D;

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
    stage<T, D>(v_s, vh, nk, [&](int rr) { return static_cast<size_t>(c0 + rr); }, 1.f);
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
    tile_mm<D, false>(p_s, v_s, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r - r0 >= nrows) continue;
    const size_t row = qrow(pb, head, r);
    const float l = l_i[i];
#pragma unroll
    for (int c = 0; c < NC; ++c)
      o[row * D + tx + 16 * c] = rt::from_f<T>(l == 0.f ? 0.f : acc[i][c] / l);
    if (tx == 0) lse[row] = l == 0.f ? kNegInf : m_i[i] + logf(l);
  }
}

// --------------------------------------------------------- backward: delta ----
// delta[row] = sum_d dO[row, d] * O[row, d], one thread per row.
template <typename T, int D>
__global__ void flash_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                                   float* __restrict__ delta, long long rows) {
  constexpr int V = rt::Vec<T>::n;
  const long long row = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < D; c += V) {
    float a[V], g[V];
    rt::load_vec(o + row * D + c, a);
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
template <int D>
__device__ __forceinline__ void recompute(const Problem& pb, const float* q_s, const float* do_s,
                                          const float* k_s, const float* v_s,
                                          const float* lse_s, const float* delta_s,
                                          const int lim[4], int c0, float p[4][4],
                                          float ds[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float th[4][4], dp[4][4];
  dot_tile<D>(q_s, k_s, p);
  softcap(p, th, pb.softcap);
  dot_tile<D>(do_s, v_s, dp);
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
template <typename T, int D>
__device__ __forceinline__ int stage_queries(const Problem& pb, size_t head, int r0,
                                             const T* __restrict__ q, const T* __restrict__ dout,
                                             const float* __restrict__ lse,
                                             const float* __restrict__ delta, float* q_s,
                                             float* do_s, float* lse_s, float* delta_s) {
  const int nrows = pb.rows() - r0 < kBQ ? pb.rows() - r0 : kBQ;
  auto row_of = [&](int rr) { return qrow(pb, head, r0 + rr); };
  stage<T, D>(q_s, q, nrows, row_of, pb.scale);
  stage<T, D>(do_s, dout, nrows, row_of, 1.f);
  for (int rr = threadIdx.x; rr < kBQ; rr += kThreads) {
    const bool ok = rr < nrows;
    lse_s[rr] = ok ? lse[row_of(rr)] : 0.f;
    delta_s[rr] = ok ? delta[row_of(rr)] : 0.f;
  }
  return nrows;
}

// --------------------------------------------------------- backward: dK/dV ----
template <int D>
constexpr size_t dkdv_smem_floats() {
  return 4 * kBQ * (D + 1) + 2 * kBQ * kPP + 2 * kBQ;   // k, v, q, dO; p, dS; lse, delta
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      Problem pb) {
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + kBK * (D + 1);
  float* q_s = v_s + kBK * (D + 1);
  float* do_s = q_s + kBQ * (D + 1);
  float* p_s = do_s + kBQ * (D + 1);
  float* ds_s = p_s + kBQ * kPP;
  float* lse_s = ds_s + kBQ * kPP;
  float* delta_s = lse_s + kBQ;

  const int c0 = blockIdx.x * kBK, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nk = pb.Sk - c0 < kBK ? pb.Sk - c0 : kBK;
  const size_t head = static_cast<size_t>(b) * pb.hkv + h;
  const T* kh = k + head * pb.Sk * D;
  const T* vh = v + head * pb.Sk * D;
  stage<T, D>(k_s, kh, nk, [&](int rr) { return static_cast<size_t>(c0 + rr); }, 1.f);
  stage<T, D>(v_s, vh, nk, [&](int rr) { return static_cast<size_t>(c0 + rr); }, 1.f);

  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // causal: the first query position that sees column c0 is c0 - offset
  int t_first = pb.causal ? c0 - pb.offset : 0;
  t_first = t_first < 0 ? 0 : t_first;
  const int rows = pb.rows();
  for (int r0 = (t_first * pb.G) / kBQ * kBQ; r0 < rows; r0 += kBQ) {
    __syncthreads();   // the previous tile's readers are done
    stage_queries<T, D>(pb, head, r0, q, dout, lse, delta, q_s, do_s, lse_s, delta_s);
    __syncthreads();
    int lim[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) lim[i] = pb.limit(r0 + ty * 4 + i);
    float p[4][4], ds[4][4];
    recompute<D>(pb, q_s, do_s, k_s, v_s, lse_s, delta_s, lim, c0, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p_s[(ty * 4 + i) * kPP + tx + 16 * j] = p[i][j];
        ds_s[(ty * 4 + i) * kPP + tx + 16 * j] = ds[i][j];
      }
    __syncthreads();
    // this thread's K/V rows are ty*4+i: dV += P^T dO, dK += dS^T (q*scale)
    tile_mm<D, true>(p_s, do_s, dv_acc);
    tile_mm<D, true>(ds_s, q_s, dk_acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = ty * 4 + i;
    if (kr >= nk) continue;
    const size_t row = (head * pb.Sk + c0 + kr) * static_cast<size_t>(D);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk[row + tx + 16 * c] = rt::from_f<T>(dk_acc[i][c]);
      dv[row + tx + 16 * c] = rt::from_f<T>(dv_acc[i][c]);
    }
  }
}

// ------------------------------------------------------------ backward: dQ ----
template <int D>
constexpr size_t dq_smem_floats() {
  return 4 * kBQ * (D + 1) + kBQ * kPP + 2 * kBQ;   // q, dO, k, v; dS; lse, delta
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, Problem pb) {
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + kBQ * (D + 1);
  float* k_s = do_s + kBQ * (D + 1);
  float* v_s = k_s + kBK * (D + 1);
  float* ds_s = v_s + kBK * (D + 1);
  float* lse_s = ds_s + kBQ * kPP;
  float* delta_s = lse_s + kBQ;

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int r0 = tile * kBQ;
  const size_t head = static_cast<size_t>(b) * pb.hkv + h;
  const T* kh = k + head * pb.Sk * D;
  const T* vh = v + head * pb.Sk * D;
  const int nrows =
      stage_queries<T, D>(pb, head, r0, q, dout, lse, delta, q_s, do_s, lse_s, delta_s);
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
    stage<T, D>(v_s, vh, nk, [&](int rr) { return static_cast<size_t>(c0 + rr); }, 1.f);
    __syncthreads();
    float p[4][4], ds[4][4];
    recompute<D>(pb, q_s, do_s, k_s, v_s, lse_s, delta_s, lim, c0, p, ds);
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

// ====================================================== bf16: tensor cores ====
namespace tc {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kFwdWarps = 8;               // forward block: 8 warps
constexpr int kFwdM = 16 * kFwdWarps;      // query rows per forward block
constexpr int kBwdWarps = 4;               // dK/dV and dQ blocks: 4 warps
constexpr int kBwdM = 16 * kBwdWarps;      // K/V rows per dK/dV block, q rows per dQ block
constexpr int kBN = 64;                    // K/V rows per streamed tile

// q rows per step of the dK/dV loop: 32 at D = 128 keeps the four
// accumulator tiles (dK, dV, S^T, dP^T) in registers
template <int D>
__host__ __device__ constexpr int dkdv_q() { return D <= 64 ? 64 : 32; }

// Shared-memory tiles are [R, D] bf16 in wgmma's canonical swizzled
// layout, each at a 1024-byte boundary.  D >= 64: panels of 64 columns
// ([R, 64] each, 128-byte rows, 128-byte swizzle: 16-byte chunk c of row r
// at chunk c ^ (r % 8)); D = 32: 64-byte rows, 64-byte swizzle (chunk
// c ^ (r / 2 % 4)).  The swizzle is what the hardware applies to the
// address, so the 8 rows a wgmma core matrix reads lie in 8 different
// bank groups.
template <int D>
constexpr int kRowElems = D >= 64 ? 64 : D;            // elements in one swizzled row
template <int D>
constexpr uint32_t kSwizzle = D >= 64 ? 1 : 2;         // descriptor layout: 128B / 64B

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

// Start copying R rows of D bf16 into a swizzled tile (NT threads): tile
// row i < valid from src + row_of(i) * D, the others zero-filled.
template <int D, int R, int NT, typename RowOf>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* __restrict__ src, int valid,
                                          RowOf row_of) {
  constexpr int C = D / 8;
  static_assert((R * C) % NT == 0, "a tile splits evenly over the threads");
#pragma unroll
  for (int it = 0; it < R * C / NT; ++it) {
    const int i = it * NT + static_cast<int>(threadIdx.x), r = i / C, c = i % C;
    const bool ok = r < valid;
    mma::cp_async16(dst + tile_off<D, R>(r, c), ok ? src + row_of(r) * D + c * 8 : src, ok);
  }
}

// Rows [r0, r0 + 16) of a swizzled tile -- one warp's -- to dst + row_of(i) * D,
// 16 bytes a lane; rows >= valid are skipped.
template <int D, int R, typename RowOf>
__device__ __forceinline__ void store_rows(const bf16* tile, bf16* __restrict__ dst, int r0,
                                           int valid, RowOf row_of) {
  constexpr int C = D / 8;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int it = 0; it < 16 * C / 32; ++it) {
    const int i = it * 32 + lane, r = r0 + i / C, c = i % C;
    if (r < valid)
      *reinterpret_cast<uint4*>(dst + row_of(r) * D + c * 8) =
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

// Issue c += A B^T over D for this warpgroup (64 rows): A the rows
// [a0, a0 + 64) of tile a (RA rows), B the N rows of tile b (N = 8 NC:
// 64 or 32); c is the 64 x N D tile.  The caller fences, commits and waits.
template <int D, int RA, int NC>
__device__ __forceinline__ void issue_abt(float (&c)[NC][4], const bf16* a, int a0,
                                          const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da = kdesc<D, RA>(a, a0, kk), db = kdesc<D, 8 * NC>(b, 0, kk);
    if constexpr (NC == 8)
      mma::wgmma_ss_n64<0>(c, da, db);
    else
      mma::wgmma_ss_n32<0>(c, da, db);
  }
}

// Issue c += P B for this warpgroup: P a 64 x 16KS bf16 A operand in
// registers, B the 16KS rows of tile b ([16KS, D], MN-major); c is 64 x D.
template <int D, int KS>
__device__ __forceinline__ void issue_pb(float (&c)[D / 8][4], const uint32_t (&pa)[KS][4],
                                         const bf16* b) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    if constexpr (D == 128) {
      mma::wgmma_rs_n64<0>(c, pa[ks], ndesc<D, 16 * KS>(b, ks, 0));
      mma::wgmma_rs_n64<8>(c, pa[ks], ndesc<D, 16 * KS>(b, ks, 1));
    } else if constexpr (D == 64) {
      mma::wgmma_rs_n64<0>(c, pa[ks], ndesc<D, 16 * KS>(b, ks, 0));
    } else {
      mma::wgmma_rs_n32<0>(c, pa[ks], ndesc<D, 16 * KS>(b, ks, 0));
    }
  }
}

// The block's dynamic shared memory from its first 1024-byte boundary (the
// launchers ask for kAlign bytes more).
constexpr size_t kAlign = 1024;
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((kAlign - (mma::smem_addr(raw) & (kAlign - 1))) & (kAlign - 1));
}

// Two-stage ring of K/V tiles filled by TMA: stage j % 2 holds K, then V,
// of tile j ([kBN, D] each, in the swizzled layout), complete when its
// mbarrier full[j % 2] completes its (j / 2)-th phase.  Rows past Sk
// arrive as zeros (the tensor map's bounds).
template <int D>
struct KvRing {
  static constexpr size_t kBytes = 4 * kBN * D * sizeof(bf16) + 2 * sizeof(uint64_t);
  bf16* tiles;
  uint64_t* full;
  __device__ explicit KvRing(void* at)
      : tiles(static_cast<bf16*>(at)), full(reinterpret_cast<uint64_t*>(tiles + 4 * kBN * D)) {}
  __device__ bf16* k(int j) const { return tiles + (j & 1) * 2 * kBN * D; }
  __device__ bf16* v(int j) const { return k(j) + kBN * D; }
  // One thread, before any use: the two barriers (a block barrier must
  // follow before other threads wait).
  __device__ void init() const {
    mma::mbar_init(full, 1);
    mma::mbar_init(full + 1, 1);
    mma::mbar_init_fence();
  }
  // One thread: start loading tile j of kv head `head`, one box per
  // swizzled column panel.
  __device__ void load(const CUtensorMap* tk, const CUtensorMap* tv, int head, int j) const {
    uint64_t* bar = full + (j & 1);
    mma::mbar_expect_tx(bar, 2 * kBN * D * sizeof(bf16));
#pragma unroll
    for (int p = 0; p < D / kRowElems<D>; ++p) {
      mma::tma_load_3d(k(j) + p * kBN * 64, tk, p * 64, j * kBN, head, bar);
      mma::tma_load_3d(v(j) + p * kBN * 64, tv, p * 64, j * kBN, head, bar);
    }
  }
  __device__ void wait(int j) const { mma::mbar_wait(full + (j & 1), (j >> 1) & 1); }
};

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

// One K/V tile of the online softmax, for this thread's two rows of a
// 16 x 8NS score tile (D layout): scores to log2 units; under kMask, the
// entries past each row's last visible column lim get p = 0; the running
// max m and sum l move on, s becomes p, and alpha is what the output
// accumulators are multiplied by.  cb: the column of entry (n = 0, e = 0).
template <bool kMask, int NS>
__device__ __forceinline__ void online_softmax(float (&s)[NS][4], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], int cb, const int (&lim)[2],
                                               const Score& score) {
  float mx[2] = {kNegInf, kNegInf};
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
template <int D>
constexpr size_t fwd_smem() {   // Q tile + the K/V ring
  return kFwdM * D * sizeof(bf16) + KvRing<D>::kBytes + kAlign;
}

template <int D>
__global__ void __launch_bounds__(kFwdWarps * 32, D <= 64 ? 2 : 1)
fwd_kernel(const bf16* __restrict__ q, const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
           float* __restrict__ lse, Problem pb) {
  constexpr int NT = kFwdWarps * 32, NS = kBN / 8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(aligned_smem(tc_smem));
  const KvRing<D> ring(q_s + kFwdM * D);

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
  load_rows<D, kFwdM, NT>(q_s, q, nrows, q_of);
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
  float acc[D / 8][4] = {};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // m in log2 units

  for (int j = 0; j < ntiles; ++j) {
    if (threadIdx.x == 0 && j + 1 < ntiles) ring.load(&tk, &tv, head, j + 1);
    ring.wait(j);
    const bf16* k_s = ring.k(j);

    float s[NS][4] = {}, alpha[2];
    mma::fence_regs(s);
    mma::wgmma_fence();
    issue_abt<D, kFwdM>(s, q_s, (warp >> 2) * 64, k_s);   // S = Q K^T, this warpgroup's rows
    mma::wgmma_commit();
    mma::wgmma_wait<0>();
    mma::fence_regs(s);
    const int cb = j * kBN + (lane & 3) * 2;
    if ((j + 1) * kBN - 1 <= lim_lo)   // every row sees the whole tile
      online_softmax<false>(s, m, l, alpha, cb, lim, score);
    else
      online_softmax<true>(s, m, l, alpha, cb, lim, score);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
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
    issue_pb<D>(acc, pa, ring.v(j));   // O += P V
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
  acc_to_tile<D, kFwdM>(q_s, warp * 16, acc, inv[0], inv[1]);   // the warp's own Q rows
  __syncwarp();
  store_rows<D, kFwdM>(q_s, o, warp * 16, nrows, q_of);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (rw + 8 * i < nrows)
        lse[q_of(rw + 8 * i)] = l[i] == 0.f ? kNegInf : (m[i] + log2f(l[i])) / kLog2e;
  }
}

// --------------------------------------------------------- backward: dK/dV ----
template <int D>
constexpr size_t dkdv_smem() {   // K, V; two stages of (Q, dO, lse, delta, limit)
  return 2 * kBwdM * D * sizeof(bf16) + 2 * dkdv_q<D>() * (2 * D * sizeof(bf16) + 12) + kAlign;
}

template <int D>
__global__ void __launch_bounds__(kBwdWarps * 32)
dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
            const bf16* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
            Problem pb) {
  constexpr int NT = kBwdWarps * 32, BQ = dkdv_q<D>(), NS = BQ / 8, ST = 2 * BQ * D;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* k_s = reinterpret_cast<bf16*>(aligned_smem(tc_smem));
  bf16* v_s = k_s + kBwdM * D;
  bf16* qd_s = v_s + kBwdM * D;   // stage s: Q at qd_s + s ST, dO after it
  float* lse_s = reinterpret_cast<float*>(qd_s + 2 * ST);   // [2][BQ]
  float* delta_s = lse_s + 2 * BQ;
  int* lim_s = reinterpret_cast<int*>(delta_s + 2 * BQ);

  const size_t head = blockIdx.x;
  const int c0 = blockIdx.y * kBwdM;   // causal: the first K/V tiles are the longest
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nk = min(pb.Sk - c0, kBwdM);
  auto kv_of = [&](int rr) { return head * pb.Sk + c0 + rr; };
  load_rows<D, kBwdM, NT>(k_s, k, nk, kv_of);
  load_rows<D, kBwdM, NT>(v_s, v, nk, kv_of);

  // causal: the first query position that sees column c0 is c0 - offset
  const int t_first = pb.causal ? max(c0 - pb.offset, 0) : 0;
  const int rows = pb.rows();
  const int first = static_cast<int>(min(static_cast<long long>(t_first) * pb.G,
                                         static_cast<long long>(rows)) / BQ);
  const int ntiles = (rows + BQ - 1) / BQ - first;
  auto load_q = [&](int i) {
    const int s = i & 1, rq = (first + i) * BQ, n = min(rows - rq, BQ);
    auto q_of = [&](int rr) { return qrow(pb, head, rq + rr); };
    load_rows<D, BQ, NT>(qd_s + s * ST, q, n, q_of);
    load_rows<D, BQ, NT>(qd_s + s * ST + BQ * D, dout, n, q_of);
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
  float dka[D / 8][4] = {}, dva[D / 8][4] = {};
  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) load_q(i + 1);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();
    mma::fence_async_smem();
    __syncthreads();
    const int s = i & 1;
    const bf16* q_s = qd_s + s * ST;
    const bf16* do_s = q_s + BQ * D;

    float st[NS][4] = {}, dpt[NS][4] = {};   // S^T, dP^T: K/V rows x q rows
    mma::fence_regs(st);
    mma::fence_regs(dpt);
    mma::wgmma_fence();
    issue_abt<D, kBwdM>(st, k_s, 0, q_s);
    issue_abt<D, kBwdM>(dpt, v_s, 0, do_s);
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
    issue_pb<D>(dva, pa, do_s);   // dV += P^T dO
    issue_pb<D>(dka, da, q_s);    // dK += dS^T Q
    mma::wgmma_commit();
    mma::wgmma_wait<0>();
    mma::fence_regs(dva);
    mma::fence_regs(dka);
    __syncthreads();
  }

  mma::cp_async_wait<0>();
  __syncthreads();
  acc_to_tile<D, kBwdM>(k_s, kr, dka, pb.scale, pb.scale);   // dK takes the scale once
  acc_to_tile<D, kBwdM>(v_s, kr, dva, 1.f, 1.f);
  __syncwarp();
  store_rows<D, kBwdM>(k_s, dk, kr, nk, kv_of);
  store_rows<D, kBwdM>(v_s, dv, kr, nk, kv_of);
}

// ------------------------------------------------------------ backward: dQ ----
template <int D>
constexpr size_t dq_smem() {   // Q, dO; the K/V ring
  return 2 * kBwdM * D * sizeof(bf16) + KvRing<D>::kBytes + kAlign;
}

template <int D>
__global__ void __launch_bounds__(kBwdWarps * 32)
dq_kernel(const bf16* __restrict__ q, const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv, const bf16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          bf16* __restrict__ dq, Problem pb) {
  constexpr int NT = kBwdWarps * 32, NS = kBN / 8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(aligned_smem(tc_smem));
  bf16* do_s = q_s + kBwdM * D;
  const KvRing<D> ring(do_s + kBwdM * D);

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
  load_rows<D, kBwdM, NT>(q_s, q, nrows, q_of);
  load_rows<D, kBwdM, NT>(do_s, dout, nrows, q_of);
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
  float acc[D / 8][4] = {};
  for (int j = 0; j < ntiles; ++j) {
    if (threadIdx.x == 0 && j + 1 < ntiles) ring.load(&tk, &tv, head, j + 1);
    ring.wait(j);
    const bf16* k_s = ring.k(j);

    float s[NS][4] = {}, dp[NS][4] = {};
    mma::fence_regs(s);
    mma::fence_regs(dp);
    mma::wgmma_fence();
    issue_abt<D, kBwdM>(s, q_s, 0, k_s);
    issue_abt<D, kBwdM>(dp, do_s, 0, ring.v(j));
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
    issue_pb<D>(acc, pa, k_s);   // dQ += dS K
    mma::wgmma_commit();
    mma::wgmma_wait<0>();
    mma::fence_regs(acc);
    __syncthreads();
  }

  __syncthreads();
  acc_to_tile<D, kBwdM>(q_s, warp * 16, acc, pb.scale, pb.scale);
  __syncwarp();
  store_rows<D, kBwdM>(q_s, dq, warp * 16, nrows, q_of);
}

}  // namespace tc

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
template <int D>
cudaError_t fwd_f32(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                    const Problem& pb, cudaStream_t s) {
  constexpr size_t smem = fwd_smem_floats<D>() * sizeof(float);
  auto kernel = flash_fwd_kernel<float, D>;
  static const cudaError_t attr = rt::set_smem(kernel, smem);   // once per process
  return launch(kernel, attr, dim3((pb.rows() + kBQ - 1) / kBQ, pb.hkv, B), kThreads, smem, s,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<float*>(o), lse, pb);
}

template <int D>
cudaError_t bwd_f32(const float* q, const float* k, const float* v, const float* dout,
                    const float* lse, const float* delta, float* dq, float* dk, float* dv, int B,
                    const Problem& pb, cudaStream_t s) {
  constexpr size_t smem_kv = dkdv_smem_floats<D>() * sizeof(float);
  auto kv_kernel = flash_bwd_dkdv_kernel<float, D>;
  static const cudaError_t attr_kv = rt::set_smem(kv_kernel, smem_kv);
  cudaError_t err = launch(kv_kernel, attr_kv, dim3((pb.Sk + kBK - 1) / kBK, pb.hkv, B),
                           kThreads, smem_kv, s, q, k, v, dout, lse, delta, dk, dv, pb);
  if (err != cudaSuccess) return err;
  constexpr size_t smem_q = dq_smem_floats<D>() * sizeof(float);
  auto q_kernel = flash_bwd_dq_kernel<float, D>;
  static const cudaError_t attr_q = rt::set_smem(q_kernel, smem_q);
  return launch(q_kernel, attr_q, dim3((pb.rows() + kBQ - 1) / kBQ, pb.hkv, B), kThreads,
                smem_q, s, q, k, v, dout, lse, delta, dq, pb);
}

// cuTensorMapEncodeTiled, fetched from the driver at run time (the
// libraries link only the runtime); null if the driver lacks it.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
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

// TMA maps of k and v, [heads, Sk, D] bf16: a box is one swizzled column
// panel of a K/V tile (kBN rows), in the layout the kernels' wgmma
// descriptors read; rows past Sk load as zeros.
template <int D>
cudaError_t kv_maps(CUtensorMap* tk, CUtensorMap* tv, const void* k, const void* v, int heads,
                    int Sk) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {D, static_cast<cuuint64_t>(Sk), static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {D * sizeof(__nv_bfloat16),
                                 static_cast<cuuint64_t>(Sk) * D * sizeof(__nv_bfloat16)};
  const cuuint32_t box[3] = {tc::kRowElems<D>, tc::kBN, 1}, unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      D >= 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  for (auto [map, base] : {std::pair{tk, k}, std::pair{tv, v}}) {
    if (encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
               box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

// bf16: the tensor-core kernels.  Grid x: (b, kv head); y: tiles, which
// each kernel walks longest first.
template <int D>
cudaError_t fwd_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                     const Problem& pb, cudaStream_t s) {
  using tc::bf16;
  CUtensorMap tk, tv;
  const cudaError_t err = kv_maps<D>(&tk, &tv, k, v, B * pb.hkv, pb.Sk);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = tc::fwd_smem<D>();
  auto kernel = tc::fwd_kernel<D>;
  static const cudaError_t attr = rt::set_smem(kernel, smem);
  return launch(kernel, attr, dim3(B * pb.hkv, (pb.rows() + tc::kFwdM - 1) / tc::kFwdM),
                tc::kFwdWarps * 32, smem, s, static_cast<const bf16*>(q), tk, tv,
                static_cast<bf16*>(o), lse, pb);
}

template <int D>
cudaError_t bwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                     const __nv_bfloat16* dout, const float* lse, const float* delta,
                     __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv, int B,
                     const Problem& pb, cudaStream_t s) {
  constexpr size_t smem_kv = tc::dkdv_smem<D>();
  auto kv_kernel = tc::dkdv_kernel<D>;
  static const cudaError_t attr_kv = rt::set_smem(kv_kernel, smem_kv);
  cudaError_t err = launch(kv_kernel, attr_kv,
                           dim3(B * pb.hkv, (pb.Sk + tc::kBwdM - 1) / tc::kBwdM),
                           tc::kBwdWarps * 32, smem_kv, s, q, k, v, dout, lse, delta, dk, dv, pb);
  if (err != cudaSuccess) return err;
  CUtensorMap tk, tv;
  err = kv_maps<D>(&tk, &tv, k, v, B * pb.hkv, pb.Sk);
  if (err != cudaSuccess) return err;
  constexpr size_t smem_q = tc::dq_smem<D>();
  auto q_kernel = tc::dq_kernel<D>;
  static const cudaError_t attr_q = rt::set_smem(q_kernel, smem_q);
  return launch(q_kernel, attr_q, dim3(B * pb.hkv, (pb.rows() + tc::kBwdM - 1) / tc::kBwdM),
                tc::kBwdWarps * 32, smem_q, s, q, tk, tv, dout, lse, delta, dq, pb);
}

template <int D>
cudaError_t fwd_t(int dtype, const void* q, const void* k, const void* v, void* o, float* lse,
                  int B, const Problem& pb, cudaStream_t s) {
  switch (dtype) {
    case rt::kBF16: return fwd_bf16<D>(q, k, v, o, lse, B, pb, s);
    case rt::kF32: return fwd_f32<D>(q, k, v, o, lse, B, pb, s);
    default: return cudaErrorInvalidValue;
  }
}

// The delta pre-pass, then dK/dV and dQ.
template <typename T, int D, typename Bwd>
cudaError_t bwd_typed(Bwd bwd, const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const float* lse, float* delta, void* dq, void* dk,
                      void* dv, int B, const Problem& pb, cudaStream_t s) {
  const long long rows = static_cast<long long>(B) * pb.hkv * pb.rows();
  flash_delta_kernel<T, D><<<static_cast<unsigned>((rows + 255) / 256), 256, 0, s>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return bwd(static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
             static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), static_cast<T*>(dk),
             static_cast<T*>(dv), B, pb, s);
}

template <int D>
cudaError_t bwd_t(int dtype, const void* q, const void* k, const void* v, const void* o,
                  const void* dout, const float* lse, float* delta, void* dq, void* dk, void* dv,
                  int B, const Problem& pb, cudaStream_t s) {
  switch (dtype) {
    case rt::kBF16:
      return bwd_typed<__nv_bfloat16, D>(bwd_bf16<D>, q, k, v, o, dout, lse, delta, dq, dk, dv,
                                         B, pb, s);
    case rt::kF32:
      return bwd_typed<float, D>(bwd_f32<D>, q, k, v, o, dout, lse, delta, dq, dk, dv, B, pb,
                                 s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: [B, hkv*G, Sq, D]; k, v: [B, hkv, Sk, D]; lse: [B, hkv*G, Sq] f32.
// causal: query t sees columns <= t + Sk - Sq.  softcap <= 0: none.
// bf16 runs on the tensor cores, f32 on the FMA pipes.  Returns the
// launch's CUDA error.
extern "C" int flash_attention_fwd_launch(const void* q, const void* k, const void* v, void* o,
                                          void* lse, int B, int hkv, int G, int Sq, int Sk,
                                          int D, int causal, float scale, float softcap,
                                          int dtype, void* stream) {
  if (!valid(B, hkv, G, Sq, Sk)) return cudaSuccess;
  const Problem pb = make_problem(hkv, G, Sq, Sk, causal, scale, softcap);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (D) {
    case 32: return fwd_t<32>(dtype, q, k, v, o, l, B, pb, s);
    case 64: return fwd_t<64>(dtype, q, k, v, o, l, B, pb, s);
    case 128: return fwd_t<128>(dtype, q, k, v, o, l, B, pb, s);
    default: return cudaErrorInvalidValue;
  }
}

// The backward of flash_attention_fwd_launch from its inputs, o and lse:
// dout, dq like q; dk, dv like k; delta: f32 scratch of B*hkv*G*Sq values.
// Three launches on `stream`: the delta pre-pass, dK/dV, dQ.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* lse, const void* dout,
                                          void* delta, void* dq, void* dk, void* dv, int B,
                                          int hkv, int G, int Sq, int Sk, int D, int causal,
                                          float scale, float softcap, int dtype, void* stream) {
  if (!valid(B, hkv, G, Sq, Sk)) return cudaSuccess;
  const Problem pb = make_problem(hkv, G, Sq, Sk, causal, scale, softcap);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  switch (D) {
    case 32: return bwd_t<32>(dtype, q, k, v, o, dout, l, dl, dq, dk, dv, B, pb, s);
    case 64: return bwd_t<64>(dtype, q, k, v, o, dout, l, dl, dq, dk, dv, B, pb, s);
    case 128: return bwd_t<128>(dtype, q, k, v, o, dout, l, dl, dq, dk, dv, B, pb, s);
    default: return cudaErrorInvalidValue;
  }
}
