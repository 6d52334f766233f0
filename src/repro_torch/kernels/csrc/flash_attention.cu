// Blockwise GQA flash attention for Hopper: forward and FlashAttention-2
// backward.
//
// flash_fwd replaces the Pallas TPU kernel
// repro/kernels/flash_attention.py::flash_attention (_flash_kernel):
// causal or non-causal attention of q [B, Hq, Sq, D] against k, v
// [B, Hkv, Sk, D] with an optional tanh logit softcap.  It also writes the
// f32 log-sum-exp of each row, lse [B, Hq, Sq], which the backward needs.
// The Pallas kernel is forward-only; the backward kernels compute what the
// reference's custom VJP repro/kernels/ref.py::_flash_chunked_bwd_impl
// computes: p = exp(s - lse), delta = rowsum(dO * O), dS = p * (dP - delta)
// (times 1 - tanh^2(s/c) under a softcap), dV = P^T dO, dK = dS^T (q*scale),
// dQ = scale * dS K.
//
// Bound on an H100: operations, at training shapes.  At Sq = Sk = 2048,
// D = 64 a (row, head) does ~S/2 * 4 * D FLOPs per q row for ~2 * D * 2
// bytes of K/V per column, far above the ~295 FLOP/byte where the card
// stops being memory-bound.
//
// Design (all three kernels): 256 threads as 16 x 16, each holding a 4 x 4
// register tile of a 64 x 64 score block; products run on the CUDA cores
// in f32 from tiles staged in shared memory (rows padded to D + 1 floats:
// no bank conflicts).  Tensor cores (mma.sync / wgmma) are later work.
// GQA by index, never by repeating K/V: a 64-row query tile holds rows
// ordered (t, g) -- the G = Hq / Hkv q heads of one kv head at 64 / G
// consecutive positions -- so the G heads share each K/V tile.  Causal
// masking uses the reference oracle's offset: query t sees columns
// <= t + (Sk - Sq) (the Pallas kernel uses the diagonal, which is the same
// for Sq == Sk).  Causal skipping is at tile granularity: a block streams
// only the K/V tiles up to its own largest visible column, and the dK/dV
// block only the query tiles that see its columns.  S needs no tile
// multiple: the ragged tail is masked.  A row that sees no column writes
// zeros and lse = -1e30, as the Pallas kernel writes zeros.
//
// The backward is deterministic: no atomics.  A delta pre-pass computes
// rowsum(dO * O); one dK/dV block per (b, kv head, 64-column tile) loops
// over every query tile of its G q heads, so dK and dV sum over the group
// in registers; one dQ block per (b, kv head, 64-row query tile) loops over
// the K/V tiles and recomputes p from lse.
#include "common.cuh"

namespace {

using rt::kNegInf;

constexpr int kThreads = 256;   // 16 x 16, a 4 x 4 register tile each
constexpr int kBQ = 64;         // query rows per tile
constexpr int kBK = 64;         // K/V rows per tile
constexpr int kPP = kBK + 1;    // padded row of a score tile in shared memory

// What every kernel needs to know about the problem.
struct Problem {
  int hkv, G, Sq, Sk;
  int causal;     // 0 / 1
  int offset;     // causal: query t sees columns <= t + offset (Sk - Sq)
  float scale;    // softmax scale, applied to q
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

// ----------------------------------------------------------------- launch ----
template <typename T, int D>
cudaError_t fwd_t(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                  const Problem& pb, cudaStream_t s) {
  constexpr size_t smem = fwd_smem_floats<D>() * sizeof(float);
  auto kernel = flash_fwd_kernel<T, D>;
  static const cudaError_t attr = rt::set_smem(kernel, smem);   // once per process
  if (attr != cudaSuccess) return attr;
  const int tiles = (pb.rows() + kBQ - 1) / kBQ;
  kernel<<<dim3(tiles, pb.hkv, B), kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, pb);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_t(const void* q, const void* k, const void* v, const void* o, const void* dout,
                  const float* lse, float* delta, void* dq, void* dk, void* dv, int B,
                  const Problem& pb, cudaStream_t s) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const long long rows = static_cast<long long>(B) * pb.hkv * pb.rows();
  flash_delta_kernel<T, D><<<static_cast<unsigned>((rows + 255) / 256), 256, 0, s>>>(
      static_cast<const T*>(o), dot, delta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr size_t smem_kv = dkdv_smem_floats<D>() * sizeof(float);
  auto kv_kernel = flash_bwd_dkdv_kernel<T, D>;
  static const cudaError_t attr_kv = rt::set_smem(kv_kernel, smem_kv);
  if (attr_kv != cudaSuccess) return attr_kv;
  kv_kernel<<<dim3((pb.Sk + kBK - 1) / kBK, pb.hkv, B), kThreads, smem_kv, s>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), pb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr size_t smem_q = dq_smem_floats<D>() * sizeof(float);
  auto q_kernel = flash_bwd_dq_kernel<T, D>;
  static const cudaError_t attr_q = rt::set_smem(q_kernel, smem_q);
  if (attr_q != cudaSuccess) return attr_q;
  q_kernel<<<dim3((pb.rows() + kBQ - 1) / kBQ, pb.hkv, B), kThreads, smem_q, s>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), pb);
  return cudaGetLastError();
}

bool valid(int B, int hkv, int G, int Sq, int Sk) {
  return B > 0 && hkv > 0 && G > 0 && Sq > 0 && Sk > 0;
}

Problem make_problem(int hkv, int G, int Sq, int Sk, int causal, float scale, float softcap) {
  return Problem{hkv, G, Sq, Sk, causal ? 1 : 0, Sk - Sq, scale, softcap};
}

template <typename T>
cudaError_t fwd_dispatch(int D, const void* q, const void* k, const void* v, void* o, float* lse,
                         int B, const Problem& pb, cudaStream_t s) {
  switch (D) {
    case 32: return fwd_t<T, 32>(q, k, v, o, lse, B, pb, s);
    case 64: return fwd_t<T, 64>(q, k, v, o, lse, B, pb, s);
    case 128: return fwd_t<T, 128>(q, k, v, o, lse, B, pb, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t bwd_dispatch(int D, const void* q, const void* k, const void* v, const void* o,
                         const void* dout, const float* lse, float* delta, void* dq, void* dk,
                         void* dv, int B, const Problem& pb, cudaStream_t s) {
  switch (D) {
    case 32: return bwd_t<T, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, pb, s);
    case 64: return bwd_t<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, pb, s);
    case 128: return bwd_t<T, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, pb, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: [B, hkv*G, Sq, D]; k, v: [B, hkv, Sk, D]; lse: [B, hkv*G, Sq] f32.
// causal: query t sees columns <= t + Sk - Sq.  softcap <= 0: none.
// Returns the launch's CUDA error.
extern "C" int flash_attention_fwd_launch(const void* q, const void* k, const void* v, void* o,
                                          void* lse, int B, int hkv, int G, int Sq, int Sk,
                                          int D, int causal, float scale, float softcap,
                                          int dtype, void* stream) {
  if (!valid(B, hkv, G, Sq, Sk)) return cudaSuccess;
  const Problem pb = make_problem(hkv, G, Sq, Sk, causal, scale, softcap);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (dtype) {
    case rt::kBF16: return fwd_dispatch<__nv_bfloat16>(D, q, k, v, o, l, B, pb, s);
    case rt::kF32: return fwd_dispatch<float>(D, q, k, v, o, l, B, pb, s);
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
  switch (dtype) {
    case rt::kBF16:
      return bwd_dispatch<__nv_bfloat16>(D, q, k, v, o, dout, l, dl, dq, dk, dv, B, pb, s);
    case rt::kF32:
      return bwd_dispatch<float>(D, q, k, v, o, dout, l, dl, dq, dk, dv, B, pb, s);
    default: return cudaErrorInvalidValue;
  }
}
