// Flash-decode and positioned-chunk attention for Hopper.
//
// decode_attention replaces the Pallas TPU kernel
// repro/kernels/decode_attention.py::decode_attention (_decode_kernel):
// one query token per (row, q head) against a [S, D] KV cache row with a
// per-row valid length kv_len[b].  Bound on an H100: bytes.  Every visible
// K/V row is read once and used for G q heads, about 2*G FLOPs per byte.
// Design: the G q heads of a kv head share each 64-row K/V tile staged in
// shared memory (f32), so K/V is read from device memory once per kv head,
// not once per q head.  One block per (batch row, kv head) would give only
// B*Hkv = 32 blocks at the serving shapes for 132 SMs, so S is also split
// into ranges of whole tiles, one 128-thread block each (flash-decoding):
// 8 ranges of 256 rows at S = 2048, 256 blocks.  A block streams tiles
// only up to kv_len[b] and masks the ragged tail (no S % tile
// requirement); blocks whose range starts past kv_len[b] exit at once.
// Each block keeps an f32 online softmax; the last block of a (row, kv
// head) to finish merges the ranges' (acc, m, l) partials, counted with
// one atomic per block, so a decode step is still a single launch.  A row
// with kv_len == 0 writes zeros (and m = -1e30, l = 0), as the Pallas
// kernel does.  Optional (m, l) residuals feed split-K merges.
//
// chunk_attention replaces repro/kernels/decode_attention.py::
// chunk_attention (_chunk_kernel): a T-token chunk of queries per row at
// cache offset pos[b]; query t attends columns <= pos[b] + t.  Bound on an
// H100: operations, at prefill widths (T = 512 gives ~G*T FLOPs per K/V
// byte).  Design: the Pallas kernel holds all G*T rows of a (row, kv head)
// in one program, which at T = 512, G = 8 is 4096 rows, far more than one
// SM holds.  Here a 256-thread block takes one (row, kv head, tile of 64
// query rows).  The rows of a tile are ordered (t, g), so the G heads of a
// kv head share its K/V tiles and a tile spans only 64/G consecutive t.
// The block stops streaming K/V at its own largest column limit
// pos[b] + t_max.  Products run on the CUDA cores in f32 (a 4x4 register
// tile per thread for Q.K^T and for P.V).  Tensor cores (mma.sync/wgmma)
// are later work.
//
// decode_attention_paged and chunk_attention_paged replace
// repro/kernels/decode_attention.py::decode_attention_paged
// (_decode_paged_kernel) and ::chunk_attention_paged (_chunk_paged_kernel):
// the same two functions over a page arena [P, Hkv, ps, D] reached through
// a per-row block table bt [B, NB], K/V row j of batch row b, kv head h
// being pages[bt[b, j / ps], h, j % ps, :].  Bound: as their dense twins,
// plus the table (4 bytes per page).  Design: each kernel body is
// templated on the row addressing (dense or paged), so a pair shares one
// body.  Before each 64-row tile, the block stages the arena offsets of
// the pages the tile touches in shared memory, one table load per page;
// at the serving page size of 64 a tile is exactly one page, at 16 it
// spans four, at 128 a page spans two tiles.  A row stops at its own
// limit (kv_len, or pos + t) clamped to NB * ps, so it never reads a
// table slot past that limit, never touches scratch page 0 or an
// ungranted page unless its table points there, and gives such rows
// exactly zero softmax mass.  Arena offsets are 64-bit.  A page id out
// of [0, P) is not checked on the device: the engine only writes ids it
// was granted.
#include "common.cuh"

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
constexpr int kDecBK = 64;   // K/V rows per tile (two per lane in the softmax)

template <int D>
size_t decode_smem_floats(int G) {
  return static_cast<size_t>(G) * D           // q (pre-scaled)
       + kDecBK * (D + 1)                     // k tile (padded: no bank conflicts)
       + kDecBK * D                           // v tile
       + static_cast<size_t>(G) * kDecBK      // scores / probabilities
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
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + G * D;
  float* v_s = k_s + kDecBK * (D + 1);
  float* p_s = v_s + kDecBK * D;
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

  for (int j0 = lo; j0 < hi; j0 += kDecBK) {
    if constexpr (kPaged) {
      pf = stage_pages<D>(kv, b, h, hkv, j0, j0 + kDecBK < hi ? j0 + kDecBK : hi, pbase);
      __syncthreads();
    }
    for (int i = tid; i < kDecBK * DV; i += kDecThreads) {
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

    for (int i = tid; i < G * kDecBK; i += kDecThreads) {
      const int g = i / kDecBK, j = i % kDecBK;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s += q_s[g * D + d] * k_s[j * (D + 1) + d];
      p_s[i] = s;
    }
    __syncthreads();

    for (int g = wid; g < G; g += nw) {
      const bool ok0 = j0 + lane < hi, ok1 = j0 + lane + 32 < hi;
      const float s0 = ok0 ? p_s[g * kDecBK + lane] : kNegInf;
      const float s1 = ok1 ? p_s[g * kDecBK + lane + 32] : kNegInf;
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, rt::warp_max(fmaxf(s0, s1)));
      const float p0 = ok0 ? expf(s0 - m_new) : 0.f;
      const float p1 = ok1 ? expf(s1 - m_new) : 0.f;
      p_s[g * kDecBK + lane] = p0;
      p_s[g * kDecBK + lane + 32] = p1;
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
      for (int j = 0; j < kDecBK; ++j) a += p_s[g * kDecBK + j] * v_s[j * D + d];
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

// ----------------------------------------------------------------- chunk ----
constexpr int kChThreads = 256;   // 16 x 16 threads, a 4 x 4 register tile each
constexpr int kChBQ = 64;         // query rows per block
constexpr int kChBK = 64;         // K/V rows per tile

template <int D>
constexpr size_t chunk_smem_floats() {
  return kChBQ * (D + 1) + kChBK * (D + 1) + kChBK * D + kChBQ * (kChBK + 1);
}

template <typename T, int D, bool kPaged>
__global__ void __launch_bounds__(kChThreads)
chunk_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             KvRows kv, const int* __restrict__ pos, T* __restrict__ o,
             int hkv, int G, int T_, float scale) {
  constexpr int V = rt::Vec<T>::n;
  constexpr int DV = D / V;
  constexpr int DP = D + 1;
  constexpr int PP = kChBK + 1;
  constexpr int NC = D / 16;      // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;              // [BQ][DP]
  float* k_s = q_s + kChBQ * DP;  // [BK][DP]
  float* v_s = k_s + kChBK * DP;  // [BK][D]
  float* p_s = v_s + kChBK * D;   // [BQ][PP]
  __shared__ long long pbase[kMaxTilePages];   // paged: this tile's page offsets

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int S = kv.nb * kv.ps;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int rows = G * T_;
  const int r0 = tile * kChBQ;
  const int p0 = pos[b];
  const size_t head = static_cast<size_t>(b) * hkv + h;
  const long long dense = static_cast<long long>(head) * S * D;   // dense row 0
  int pf = 0;                       // paged: table slot of pbase[0]
  // tile row r -> (t = r / G, g = r % G); q/o [B, Hq, T, D] with q head h*G+g
  auto row_offset = [&](int r) {
    return ((head * G + r % G) * T_ + r / G) * static_cast<size_t>(D);
  };

  for (int i = tid; i < kChBQ * DV; i += kChThreads) {
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
  const int r_last = (r0 + kChBQ < rows ? r0 + kChBQ : rows) - 1;
  int ncols = p0 + r_last / G + 1;
  ncols = ncols > S ? S : ncols;

  float m_i[4], l_i[4], acc[4][NC];
  int lim[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    lim[i] = r < rows ? p0 + r / G : -1;
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  __syncthreads();

  for (int c0 = 0; c0 < ncols; c0 += kChBK) {
    if constexpr (kPaged) {
      pf = stage_pages<D>(kv, b, h, hkv, c0, c0 + kChBK < ncols ? c0 + kChBK : ncols, pbase);
      __syncthreads();
    }
    for (int i = tid; i < kChBK * DV; i += kChThreads) {
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

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty * 4 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
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
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        p_s[(ty * 4 + i) * PP + tx + 16 * j] = p;
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
    for (int j = 0; j < kChBK; ++j) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = v_s[j * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = p_s[(ty * 4 + i) * PP + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] += p * vv[c];
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
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
  const int tiles = (G * T_ + kChBQ - 1) / kChBQ;
  kernel<<<dim3(tiles, hkv, B), kChThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), kv, pos,
      static_cast<T*>(o), hkv, G, T_, scale);
  return cudaGetLastError();
}

// The kernel instance for (T, D, dense or paged).
template <typename T, int D>
cudaError_t decode_pick(const void* q, const void* k, const void* v, KvRows kv,
                        const int* kv_len, void* o, float* m, float* l, float* part, int* done,
                        int B, int hkv, int G, int nsplit, int split_rows, float scale,
                        cudaStream_t s) {
  return kv.bt != nullptr
             ? decode_launch_t<T, D, true>(q, k, v, kv, kv_len, o, m, l, part, done, B, hkv, G,
                                           nsplit, split_rows, scale, s)
             : decode_launch_t<T, D, false>(q, k, v, kv, kv_len, o, m, l, part, done, B, hkv,
                                            G, nsplit, split_rows, scale, s);
}

template <typename T>
cudaError_t decode_dispatch(int D, const void* q, const void* k, const void* v, KvRows kv,
                            const int* kv_len, void* o, float* m, float* l, float* part,
                            int* done, int B, int hkv, int G, int nsplit, int split_rows,
                            float scale, cudaStream_t s) {
  switch (D) {
    case 32:
      return decode_pick<T, 32>(q, k, v, kv, kv_len, o, m, l, part, done, B, hkv, G, nsplit,
                                split_rows, scale, s);
    case 64:
      return decode_pick<T, 64>(q, k, v, kv, kv_len, o, m, l, part, done, B, hkv, G, nsplit,
                                split_rows, scale, s);
    case 80:
      return decode_pick<T, 80>(q, k, v, kv, kv_len, o, m, l, part, done, B, hkv, G, nsplit,
                                split_rows, scale, s);
    case 128:
      return decode_pick<T, 128>(q, k, v, kv, kv_len, o, m, l, part, done, B, hkv, G, nsplit,
                                 split_rows, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int D>
cudaError_t chunk_pick(const void* q, const void* k, const void* v, KvRows kv, const int* pos,
                       void* o, int B, int hkv, int G, int T_, float scale, cudaStream_t s) {
  return kv.bt != nullptr
             ? chunk_launch_t<T, D, true>(q, k, v, kv, pos, o, B, hkv, G, T_, scale, s)
             : chunk_launch_t<T, D, false>(q, k, v, kv, pos, o, B, hkv, G, T_, scale, s);
}

template <typename T>
cudaError_t chunk_dispatch(int D, const void* q, const void* k, const void* v, KvRows kv,
                           const int* pos, void* o, int B, int hkv, int G, int T_, float scale,
                           cudaStream_t s) {
  switch (D) {
    case 32: return chunk_pick<T, 32>(q, k, v, kv, pos, o, B, hkv, G, T_, scale, s);
    case 64: return chunk_pick<T, 64>(q, k, v, kv, pos, o, B, hkv, G, T_, scale, s);
    case 80: return chunk_pick<T, 80>(q, k, v, kv, pos, o, B, hkv, G, T_, scale, s);
    case 128: return chunk_pick<T, 128>(q, k, v, kv, pos, o, B, hkv, G, T_, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

int decode_common(const void* q, const void* k, const void* v, KvRows kv, const void* kv_len,
                  void* o, void* m, void* l, void* part, void* done, int B, int hkv, int G,
                  int D, int nsplit, int split_rows, float scale, int dtype, void* stream) {
  if (B <= 0 || hkv <= 0 || G <= 0) return cudaSuccess;
  if (kv.nb < 1 || kv.ps < 1 || nsplit < 1 || nsplit > kDecBK || split_rows % kDecBK != 0 ||
      (nsplit > 1 && (part == nullptr || done == nullptr)))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(kv_len);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  float* pf = static_cast<float*>(part);
  int* dn = static_cast<int*>(done);
  switch (dtype) {
    case rt::kBF16:
      return decode_dispatch<__nv_bfloat16>(D, q, k, v, kv, len, o, mf, lf, pf, dn, B, hkv, G,
                                            nsplit, split_rows, scale, s);
    case rt::kF32:
      return decode_dispatch<float>(D, q, k, v, kv, len, o, mf, lf, pf, dn, B, hkv, G, nsplit,
                                    split_rows, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

int chunk_common(const void* q, const void* k, const void* v, KvRows kv, const void* pos,
                 void* o, int B, int hkv, int G, int T, int D, float scale, int dtype,
                 void* stream) {
  if (B <= 0 || hkv <= 0 || G <= 0 || T <= 0) return cudaSuccess;
  if (kv.nb < 1 || kv.ps < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  switch (dtype) {
    case rt::kBF16:
      return chunk_dispatch<__nv_bfloat16>(D, q, k, v, kv, p, o, B, hkv, G, T, scale, s);
    case rt::kF32:
      return chunk_dispatch<float>(D, q, k, v, kv, p, o, B, hkv, G, T, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: [B, Hkv*G, D]; k, v: [B, Hkv, S, D]; kv_len: [B] int32; o like q;
// m, l: [B, Hkv*G] f32 or both null.  S is cut into `nsplit` ranges of
// `split_rows` rows (a multiple of 64; nsplit <= 64), one block each;
// with nsplit > 1, `part` is f32 scratch of B*Hkv*nsplit*G*(D+2) values
// and `done` B*Hkv int32 zeros.  Returns the launch's CUDA error.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* kv_len, void* o, void* m, void* l,
                                       void* part, void* done, int B, int hkv, int G, int S,
                                       int D, int nsplit, int split_rows, float scale,
                                       int dtype, void* stream) {
  return decode_common(q, k, v, KvRows{nullptr, 1, S}, kv_len, o, m, l, part, done, B, hkv, G,
                       D, nsplit, split_rows, scale, dtype, stream);
}

// As decode_attention_launch over a page arena: k, v: [P, Hkv, ps, D];
// bt: [B, nb] int32 page ids; the split ranges cut the virtual S = nb*ps.
extern "C" int decode_attention_paged_launch(const void* q, const void* k, const void* v,
                                             const void* bt, const void* kv_len, void* o,
                                             void* part, void* done, int B, int hkv, int G,
                                             int nb, int ps, int D, int nsplit,
                                             int split_rows, float scale, int dtype,
                                             void* stream) {
  if (bt == nullptr) return cudaErrorInvalidValue;
  return decode_common(q, k, v, KvRows{static_cast<const int*>(bt), nb, ps}, kv_len, o,
                       nullptr, nullptr, part, done, B, hkv, G, D, nsplit, split_rows, scale,
                       dtype, stream);
}

// q: [B, Hkv*G, T, D]; k, v: [B, Hkv, S, D]; pos: [B] int32; o like q.
extern "C" int chunk_attention_launch(const void* q, const void* k, const void* v,
                                      const void* pos, void* o, int B, int hkv, int G, int T,
                                      int S, int D, float scale, int dtype, void* stream) {
  return chunk_common(q, k, v, KvRows{nullptr, 1, S}, pos, o, B, hkv, G, T, D, scale, dtype,
                      stream);
}

// As chunk_attention_launch over a page arena: k, v: [P, Hkv, ps, D];
// bt: [B, nb] int32 page ids.
extern "C" int chunk_attention_paged_launch(const void* q, const void* k, const void* v,
                                            const void* bt, const void* pos, void* o, int B,
                                            int hkv, int G, int T, int nb, int ps, int D,
                                            float scale, int dtype, void* stream) {
  if (bt == nullptr) return cudaErrorInvalidValue;
  return chunk_common(q, k, v, KvRows{static_cast<const int*>(bt), nb, ps}, pos, o, B, hkv, G,
                      T, D, scale, dtype, stream);
}
