// Row RMSNorm for Hopper: y = round(x * rsqrt(mean(x^2) + eps)) * w, its
// fused residual twin, and its gradient.
//
// rmsnorm replaces the Pallas TPU kernel repro/kernels/rmsnorm.py::rmsnorm
// (_rmsnorm_kernel).  Bound on an H100: bytes -- a row is read, reduced in
// f32 and written once, a few FLOPs a byte, far below the ~295 FLOP/byte
// where the card stops being memory-bound.  The main path calls it at two
// kinds of shape.  A decode tick normalizes 8 rows (8 x 2048 bf16 for
// tinyllama, 8 x 2560 for zamba2): 66-82 KB, 0.00002 ms at 3.35 TB/s, so
// that call is latency -- the launch, DRAM round trips, the reduction and
// the store.  A prefill group (8 x 512 x 2048) or a train step (4 x 2048 x
// 2048) moves 16-100 MB, and there it is the bytes.
//
// Design (rmsnorm and rmsnorm_bwd): a row belongs to a group of `tpr`
// threads, each holding VPT (2, 4 or 8) 16-byte vectors of it in
// registers (vectors j, j + tpr, ... so that a warp's loads are
// contiguous); tpr is a power of two up to a warp while a warp holds the
// row, whole warps above.  x and w are loaded together before the
// reduction -- one round trip -- and the sum of squares is reduced by xor
// shuffles inside the group, then across its warps with one __syncthreads.
// y is formed from the registers and stored once; rows are loaded and
// stored as streams (evict-first), w through the read-only cache.  The
// forward plan (rmsnorm.py::forward_plan) follows the width alone: 2
// vectors a thread, so 128 threads a row at 2048 bf16 and 160 at 2560, one
// row a block -- a decode tick's 8 rows start on 8 SMs, and a row's
// arithmetic is spread thin.  Measured on an H100 (PERF.md), the decode
// tick's kernel runs ~2 us of device time, as long as the design before
// it: the call is the launch, not the arithmetic; at 2560 it is 0.7 us
// shorter (one vector a thread fewer).  The normalized value is rounded to
// the io dtype before the scale, exactly as the reference oracle rounds,
// so kernel and plain version differ only by the order of the f32 sum.
//
// rmsnorm_add replaces repro/kernels/rmsnorm.py::rmsnorm_add
// (_rmsnorm_add_kernel): s = x + residual, returning (rmsnorm(s), s).
// Bound: bytes -- x and the residual are read once, s and y written once.
// Design: one block per row.  The first pass forms s in f32, rounds it to
// the io dtype, stores it and sums the squares of the ROUNDED s; the
// second pass normalizes the stored s (re-read from L1/L2).  This is the
// reference oracle's function (s = x + residual in the io dtype, then
// rmsnorm of s), so kernel and plain version differ only by the order of
// the f32 sum; the Pallas kernel normalizes the unrounded f32 s, one bf16
// ulp away at most.  No model path calls it.
//
// rmsnorm_bwd is the gradient of rmsnorm (the Pallas kernel has none).
// Bound on an H100: bytes -- x and dy are read and dx written once (100.7
// MB at 4 x 2048 x 2048 bf16, 0.030 ms).  With r = rsqrt(mean(x^2) + eps),
// g = dy * w and xhat = x * r: dx = r * (g - xhat * mean(g * xhat)),
// dw = the sum over rows of dy * round(xhat).  Design: one block of 256
// threads per SM (rmsnorm.py::backward_plan), each over a contiguous range
// of rows, `groups` rows in flight at a time (8 at 2048 bf16: 8 vectors a
// thread, a warp a row, no barrier).  A thread owns the same columns in
// every row: w is loaded once into registers, x and dy of its row are
// loaded together and kept in registers across the two row sums (x^2 and
// g * x, reduced together), dx is stored from them, and dw accumulates in
// f32 registers.  At the end the block's groups meet in shared memory and
// their dw is summed per column in group order into the block's f32
// partial [nblk, d] (nblk <= the SM count: 1.1 MB at 2048).  A second
// launch (rmsnorm_dw_reduce) sums the partials per column in a fixed
// order, 32 columns a block (64 blocks at 2048): dw is the same on every
// run.  The row pass moves its 100.7 MB at ~2.3 TB/s; fewer vectors a
// thread (2 or 4, more blocks) and a cp.async ring that keeps the next
// rows in flight measured no faster (PERF.md).
#include <climits>

#include "common.cuh"

namespace {

constexpr int kRowVecs = 8;       // 16-byte vectors a thread holds of one row, at most
constexpr int kMaxThreads = 256;  // threads a block, at most
constexpr int kRedCols = 32;      // columns a block of the dw reduction sums

template <typename T>
__device__ __forceinline__ uint4 ld16(const T* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// A 16-byte load of a row of x or dy, which is read once: streamed
// (evict-first), so w and the partials keep their cache lines.
template <typename T>
__device__ __forceinline__ uint4 ld_row(const T* p) {
  return __ldcs(reinterpret_cast<const uint4*>(p));
}

// A 16-byte store of Vec<T>::n f32 values to a row of y or dx, narrowed to
// T; written once: streamed.
template <typename T>
__device__ __forceinline__ void st_row(T* p, const float* in) {
  uint4 u;
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int i = 0; i < rt::Vec<T>::n; ++i) e[i] = rt::from_f<T>(in[i]);
  __stcs(reinterpret_cast<uint4*>(p), u);
}

// The Vec<T>::n values of a 16-byte vector, widened to f32.
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float* f) {
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < rt::Vec<T>::n; ++i) f[i] = rt::to_f(e[i]);
}

// The sums of a and b over each group of `tpr` threads; every thread of a
// group gets the same two values (a butterfly of commutative adds, then
// the group's warps in order).  tpr <= 32 (a power of two): shuffles only.
// tpr > 32 (whole warps): one __syncthreads through red[warp], which every
// thread of the block must reach.
__device__ __forceinline__ float2 group_sum2(float a, float b, int tpr, float2* red) {
  for (int off = (tpr < 32 ? tpr : 32) >> 1; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  if (tpr <= 32) return make_float2(a, b);
  const int warp = threadIdx.x >> 5, wpg = tpr >> 5, first = warp / wpg * wpg;
  if ((threadIdx.x & 31) == 0) red[warp] = make_float2(a, b);
  __syncthreads();
  float2 t = red[first];
  for (int i = 1; i < wpg; ++i) {
    t.x += red[first + i].x;
    t.y += red[first + i].y;
  }
  return t;
}

// One row per group of tpr threads, VPT vectors a thread, blockDim.x / tpr
// rows a block.
template <typename T, int VPT>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
               long long rows, int d, int tpr, float eps) {
  constexpr int V = rt::Vec<T>::n;
  __shared__ float2 red[kMaxThreads / 32];
  const int nvec = d / V, j = threadIdx.x % tpr;
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x / tpr) + threadIdx.x / tpr;
  const bool live = row < rows;   // a dead group still joins the reduction
  const size_t off = static_cast<size_t>(live ? row : 0) * d;
  uint4 xv[VPT], wv[VPT];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {   // every load in flight before any use
    const int i = j + k * tpr;
    if (live && i < nvec) {
      xv[k] = ld_row(x + off + static_cast<size_t>(i) * V);
      wv[k] = ld16(w + static_cast<size_t>(i) * V);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    if (live && j + k * tpr < nvec) {
      float f[V];
      unpack<T>(xv[k], f);
#pragma unroll
      for (int e = 0; e < V; ++e) ss += f[e] * f[e];
    }
  }
  const float r = rsqrtf(group_sum2(ss, 0.f, tpr, red).x / static_cast<float>(d) + eps);
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = j + k * tpr;
    if (live && i < nvec) {
      float f[V], s[V];
      unpack<T>(xv[k], f);
      unpack<T>(wv[k], s);
#pragma unroll
      for (int e = 0; e < V; ++e) f[e] = rt::to_f(rt::from_f<T>(f[e] * r)) * s[e];
      st_row(y + off + static_cast<size_t>(i) * V, f);
    }
  }
}

template <typename T>
__global__ void rmsnorm_add_kernel(const T* __restrict__ x, const T* __restrict__ res,
                                   const T* __restrict__ w, T* __restrict__ y,
                                   T* __restrict__ s, int d, float eps) {
  constexpr int V = rt::Vec<T>::n;
  const size_t off = static_cast<size_t>(blockIdx.x) * d;
  const int nvec = d / V;

  float ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    float a[V], r[V];
    rt::load_vec(x + off + i * V, a);
    rt::load_vec(res + off + i * V, r);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      a[j] = rt::to_f(rt::from_f<T>(a[j] + r[j]));   // s as stored
      ss += a[j] * a[j];
    }
    rt::store_vec(s + off + i * V, a);
  }
  __shared__ float part[32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  ss = rt::warp_sum(ss);
  if (lane == 0) part[wid] = ss;
  __syncthreads();
  if (wid == 0) {
    const int nw = (blockDim.x + 31) >> 5;
    ss = rt::warp_sum(lane < nw ? part[lane] : 0.f);
    if (lane == 0) part[0] = ss;
  }
  __syncthreads();
  const float r = rsqrtf(part[0] / static_cast<float>(d) + eps);

  // each thread re-reads only the vectors of s it stored itself
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    float v[V], sc[V], o[V];
    rt::load_vec(s + off + i * V, v);
    rt::load_vec(w + i * V, sc);
#pragma unroll
    for (int j = 0; j < V; ++j) o[j] = rt::to_f(rt::from_f<T>(v[j] * r)) * sc[j];
    rt::store_vec(y + off + i * V, o);
  }
}

// Rows [blockIdx.x * per, +per) of the gradient, `groups` rows at a time,
// one per group of tpr threads, kRowVecs vectors a thread; writes dx and
// the block's f32 dw partial.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 1)
rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ dy,
                   T* __restrict__ dx, float* __restrict__ dw_part, long long rows, int d,
                   int tpr, int per, float eps) {
  constexpr int V = rt::Vec<T>::n, VPT = kRowVecs;
  extern __shared__ float dw_s[];   // [groups][d]: each group's dw, at the end
  __shared__ float2 red[2][kMaxThreads / 32];   // alternate steps: one barrier a step
  const int nvec = d / V, groups = blockDim.x / tpr;
  const int g = threadIdx.x / tpr, j = threadIdx.x % tpr;
  const long long lo = static_cast<long long>(blockIdx.x) * per;
  const long long hi = lo + per < rows ? lo + per : rows;
  uint4 wv[VPT];
  float acc[VPT][V];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    if (j + k * tpr < nvec) wv[k] = ld16(w + static_cast<size_t>(j + k * tpr) * V);
#pragma unroll
    for (int e = 0; e < V; ++e) acc[k][e] = 0.f;
  }
  const int steps = (per + groups - 1) / groups;   // the same for every thread
  for (int st = 0; st < steps; ++st) {
    const long long row = lo + static_cast<long long>(st) * groups + g;
    const bool live = row < hi;
    const size_t off = static_cast<size_t>(live ? row : 0) * d;
    uint4 xv[VPT], gv[VPT];
#pragma unroll
    for (int k = 0; k < VPT; ++k) {   // x and dy in flight together
      const int i = j + k * tpr;
      if (live && i < nvec) {
        xv[k] = ld_row(x + off + static_cast<size_t>(i) * V);
        gv[k] = ld_row(dy + off + static_cast<size_t>(i) * V);
      }
    }
    float ss = 0.f, gx = 0.f;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      if (live && j + k * tpr < nvec) {
        float xf[V], gf[V], wf[V];
        unpack<T>(xv[k], xf);
        unpack<T>(gv[k], gf);
        unpack<T>(wv[k], wf);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          ss += xf[e] * xf[e];
          gx += gf[e] * wf[e] * xf[e];
        }
      }
    }
    const float2 tot = group_sum2(ss, gx, tpr, red[st & 1]);
    const float r = rsqrtf(tot.x / static_cast<float>(d) + eps);
    // mean(g * xhat) = r * sum(g * x) / d; dx = r * g - xhat * r * that
    const float c = r * r * r * tot.y / static_cast<float>(d);
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int i = j + k * tpr;
      if (live && i < nvec) {
        float xf[V], gf[V], wf[V], o[V];
        unpack<T>(xv[k], xf);
        unpack<T>(gv[k], gf);
        unpack<T>(wv[k], wf);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          o[e] = r * gf[e] * wf[e] - c * xf[e];
          acc[k][e] += gf[e] * rt::to_f(rt::from_f<T>(xf[e] * r));
        }
        st_row(dx + off + static_cast<size_t>(i) * V, o);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = j + k * tpr;
    if (i < nvec) {
#pragma unroll
      for (int e = 0; e < V; ++e) dw_s[g * d + i * V + e] = acc[k][e];
    }
  }
  __syncthreads();
  for (int col = threadIdx.x; col < d; col += blockDim.x) {
    float s = 0.f;
    for (int q = 0; q < groups; ++q) s += dw_s[q * d + col];
    dw_part[static_cast<size_t>(blockIdx.x) * d + col] = s;
  }
}

// dw[c] = the sum over blocks of dw_part[blk, c]: kRedCols columns a
// block, 32 strands of blocks each summed in block order, then the strands
// in order.  d is a multiple of 4.
template <typename T>
__global__ void __launch_bounds__(256)
rmsnorm_dw_reduce_kernel(const float* __restrict__ dw_part, T* __restrict__ dw, int nblk,
                         int d) {
  constexpr int NV = kRedCols / 4, NS = 256 / NV;   // float4 columns, strands
  __shared__ float4 acc[NS][NV];
  const int v = threadIdx.x % NV, strand = threadIdx.x / NV;
  const int col = blockIdx.x * kRedCols + v * 4;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (col < d) {
    for (int b = strand; b < nblk; b += NS) {
      const float4 p = *reinterpret_cast<const float4*>(dw_part + static_cast<size_t>(b) * d + col);
      s.x += p.x;
      s.y += p.y;
      s.z += p.z;
      s.w += p.w;
    }
  }
  acc[strand][v] = s;
  __syncthreads();
  if (threadIdx.x < NV && col < d) {
    float4 t = acc[0][v];
    for (int q = 1; q < NS; ++q) {
      t.x += acc[q][v].x;
      t.y += acc[q][v].y;
      t.z += acc[q][v].z;
      t.w += acc[q][v].w;
    }
    dw[col] = rt::from_f<T>(t.x);
    dw[col + 1] = rt::from_f<T>(t.y);
    dw[col + 2] = rt::from_f<T>(t.z);
    dw[col + 3] = rt::from_f<T>(t.w);
  }
}

// A row plan the kernels take: tpr threads a row (a power of two up to a
// warp, or whole warps) holding it at vpt vectors a thread (2, 4 or
// kRowVecs), `groups` rows a block, whole warps a block.
inline bool plan_ok(int d, int vec, int vpt, int tpr, int groups) {
  if (d <= 0 || d % vec != 0 || tpr < 1 || groups < 1) return false;
  if (vpt != 2 && vpt != 4 && vpt != kRowVecs) return false;
  if (tpr * groups > kMaxThreads || (tpr * groups) % 32 != 0) return false;
  if (tpr <= 32 ? (tpr & (tpr - 1)) != 0 : tpr % 32 != 0) return false;
  return static_cast<long long>(tpr) * vpt >= d / vec;
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* y, long long rows, int d, int vpt,
                   int tpr, int groups, float eps, cudaStream_t stream) {
  if (!plan_ok(d, rt::Vec<T>::n, vpt, tpr, groups)) return cudaErrorInvalidValue;
  const long long blocks = (rows + groups - 1) / groups;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  auto kernel = vpt == 2 ? rmsnorm_kernel<T, 2>
                : vpt == 4 ? rmsnorm_kernel<T, 4> : rmsnorm_kernel<T, kRowVecs>;
  kernel<<<static_cast<unsigned>(blocks), tpr * groups, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), rows, d, tpr,
      eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t add_launch(const void* x, const void* res, const void* w, void* y, void* s,
                       long long rows, int d, float eps, cudaStream_t stream) {
  const int nvec = d / rt::Vec<T>::n;
  int threads = (nvec + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  rmsnorm_add_kernel<T><<<static_cast<unsigned>(rows), threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), static_cast<const T*>(w),
      static_cast<T*>(y), static_cast<T*>(s), d, eps);
  return cudaGetLastError();
}


template <typename T>
cudaError_t bwd_launch(const void* x, const void* w, const void* dy, void* dx, void* dw,
                       float* dw_part, long long rows, int d, int tpr, int groups, int per,
                       int nblk, float eps, cudaStream_t stream) {
  if (!plan_ok(d, rt::Vec<T>::n, kRowVecs, tpr, groups) || per < 1 || nblk < 1 ||
      static_cast<long long>(nblk) * per < rows || static_cast<long long>(nblk - 1) * per >= rows)
    return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(groups) * d * sizeof(float);
  auto kernel = rmsnorm_bwd_kernel<T>;
  cudaError_t err = rt::set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<nblk, tpr * groups, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(dy),
      static_cast<T*>(dx), dw_part, rows, d, tpr, per, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rmsnorm_dw_reduce_kernel<T><<<(d + kRedCols - 1) / kRedCols, 256, 0, stream>>>(
      dw_part, static_cast<T*>(dw), nblk, d);
  return cudaGetLastError();
}

}  // namespace

// x, y: [rows, d] contiguous; w: [d].  tpr threads a row holding vpt
// vectors each, `groups` rows a block (rmsnorm.py::forward_plan).  Returns
// the launch's CUDA error.
extern "C" int rmsnorm_launch(const void* x, const void* w, void* y, long long rows,
                              int d, int vpt, int tpr, int groups, float eps, int dtype,
                              void* stream) {
  if (rows <= 0 || d <= 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::kBF16:
      return launch<__nv_bfloat16>(x, w, y, rows, d, vpt, tpr, groups, eps, s);
    case rt::kF32: return launch<float>(x, w, y, rows, d, vpt, tpr, groups, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

// x, res, y, s: [rows, d] contiguous; w: [d].  s = x + res, y = rmsnorm(s).
extern "C" int rmsnorm_add_launch(const void* x, const void* res, const void* w, void* y,
                                  void* s, long long rows, int d, float eps, int dtype,
                                  void* stream) {
  if (rows <= 0) return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::kBF16: return add_launch<__nv_bfloat16>(x, res, w, y, s, rows, d, eps, st);
    case rt::kF32: return add_launch<float>(x, res, w, y, s, rows, d, eps, st);
    default: return cudaErrorInvalidValue;
  }
}

// The backward of rmsnorm_launch: x, dy, dx: [rows, d]; w, dw: [d] (all in
// `dtype`); dw_part: f32 scratch of nblk * d values.  Block b takes rows
// [b * per, (b + 1) * per), tpr threads a row holding kRowVecs vectors
// each and `groups` rows at a time (rmsnorm.py::backward_plan; the blocks
// must cover the rows, none empty).  Two launches: the row pass and the
// per-column sum of the blocks' dw partials.
extern "C" int rmsnorm_bwd_launch(const void* x, const void* w, const void* dy, void* dx,
                                  void* dw, void* dw_part, long long rows, int d, int tpr,
                                  int groups, int per, int nblk, float eps, int dtype,
                                  void* stream) {
  if (rows <= 0 || d <= 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(dw_part);
  switch (dtype) {
    case rt::kBF16:
      return bwd_launch<__nv_bfloat16>(x, w, dy, dx, dw, part, rows, d, tpr, groups, per,
                                       nblk, eps, s);
    case rt::kF32:
      return bwd_launch<float>(x, w, dy, dx, dw, part, rows, d, tpr, groups, per, nblk, eps,
                               s);
    default: return cudaErrorInvalidValue;
  }
}
