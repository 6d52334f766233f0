// Row RMSNorm for Hopper: y = round(x * rsqrt(mean(x^2) + eps)) * w.
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm.py::rmsnorm
// (_rmsnorm_kernel).  Bound on an H100: bytes.  A row is read, reduced in
// f32 and written once; the work per byte is a few FLOPs, far below the
// ~295 FLOP/byte where the card stops being memory-bound.
//
// Design: one block per row.  Each thread moves 16 bytes per load (8 bf16
// values), so a 2048-wide bf16 row is one load per thread of a 256-thread
// block; narrow rows (qk-norm over a 64-wide head) get a single warp.  The
// sum of squares is reduced with warp shuffles, then across warps through
// shared memory.  The second pass re-reads the row from L1/L2, not from
// device memory.  The normalized value is rounded to the input dtype
// before the scale is applied, exactly as the reference oracle rounds,
// so kernel and plain version differ only by the order of the f32 sum.
//
// rmsnorm_add replaces repro/kernels/rmsnorm.py::rmsnorm_add
// (_rmsnorm_add_kernel): s = x + residual, returning (rmsnorm(s), s).
// Bound: bytes -- x and the residual are read once, s and y written once.
// Design: rmsnorm's one block per row, with a second input and a second
// output.  The first pass forms s in f32, rounds it to the io dtype, stores
// it and sums the squares of the ROUNDED s; the second pass normalizes the
// stored s (re-read from L1/L2).  This is the reference oracle's function
// (s = x + residual in the io dtype, then rmsnorm of s), so kernel and
// plain version differ only by the order of the f32 sum; the Pallas kernel
// normalizes the unrounded f32 s, one bf16 ulp away at most.
//
// rmsnorm_bwd is the gradient of that function (the Pallas kernel has
// none).  Bound on an H100: bytes -- x and dy are read and dx written once.
// With r = rsqrt(mean(x^2) + eps), g = dy * w and xhat = x * r:
// dx = r * (g - xhat * mean(g * xhat)), dw = sum over rows of
// dy * round(xhat).  Design: a block walks a contiguous range of rows, one
// row at a time as the forward does (16-byte loads, the two row sums --
// x^2 and g * x -- reduced together in one pass), and keeps its share of dw
// in shared memory, each thread owning its own columns, so no atomics.  The
// blocks' f32 partials [nblk, d] are then summed per column by a second
// launch (rmsnorm_dw_reduce), in a fixed order: the result is the same on
// every run.
#include "common.cuh"

namespace {

template <typename T>
__global__ void rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                               T* __restrict__ y, int d, float eps) {
  constexpr int V = rt::Vec<T>::n;
  const size_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;
  const int nvec = d / V;

  float ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    float v[V];
    rt::load_vec(xr + i * V, v);
#pragma unroll
    for (int j = 0; j < V; ++j) ss += v[j] * v[j];
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

  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    float v[V], s[V], o[V];
    rt::load_vec(xr + i * V, v);
    rt::load_vec(w + i * V, s);
#pragma unroll
    for (int j = 0; j < V; ++j) o[j] = rt::to_f(rt::from_f<T>(v[j] * r)) * s[j];
    rt::store_vec(yr + i * V, o);
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

template <typename T>
cudaError_t launch(const void* x, const void* w, void* y, long long rows, int d,
                   float eps, cudaStream_t stream) {
  const int nvec = d / rt::Vec<T>::n;
  int threads = (nvec + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  rmsnorm_kernel<T><<<static_cast<unsigned>(rows), threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), d, eps);
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

// Block reduction of two sums at once; every thread gets both totals.
__device__ __forceinline__ float2 block_sum2(float a, float b, float2* part) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  a = rt::warp_sum(a);
  b = rt::warp_sum(b);
  if (lane == 0) part[wid] = make_float2(a, b);
  __syncthreads();
  if (wid == 0) {
    const int nw = (blockDim.x + 31) >> 5;
    float2 t = lane < nw ? part[lane] : make_float2(0.f, 0.f);
    t.x = rt::warp_sum(t.x);
    t.y = rt::warp_sum(t.y);
    if (lane == 0) part[32] = t;
  }
  __syncthreads();
  const float2 r = part[32];
  __syncthreads();   // part is reused by the next row
  return r;
}

template <typename T>
__global__ void rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                                   const T* __restrict__ dy, T* __restrict__ dx,
                                   float* __restrict__ dw_part, long long rows, int d,
                                   int rows_per_block, float eps) {
  constexpr int V = rt::Vec<T>::n;
  extern __shared__ float dw_s[];   // [d] this block's share of dw
  __shared__ float2 part[33];
  const int nvec = d / V;
  for (int i = threadIdx.x; i < d; i += blockDim.x) dw_s[i] = 0.f;
  __syncthreads();   // below, each thread owns the columns of its vectors
  const long long r_lo = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r_hi = r_lo + rows_per_block < rows ? r_lo + rows_per_block : rows;
  for (long long row = r_lo; row < r_hi; ++row) {
    const T* xr = x + row * d;
    const T* gr = dy + row * d;
    float ss = 0.f, gx = 0.f;
    for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
      float xv[V], gv[V], wv[V];
      rt::load_vec(xr + i * V, xv);
      rt::load_vec(gr + i * V, gv);
      rt::load_vec(w + i * V, wv);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        ss += xv[j] * xv[j];
        gx += gv[j] * wv[j] * xv[j];
      }
    }
    const float2 tot = block_sum2(ss, gx, part);
    const float r = rsqrtf(tot.x / static_cast<float>(d) + eps);
    // mean(g * xhat) = r * sum(g * x) / d; dx = r * g - xhat * r * that
    const float c = r * r * r * tot.y / static_cast<float>(d);
    for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
      float xv[V], gv[V], wv[V], o[V];
      rt::load_vec(xr + i * V, xv);
      rt::load_vec(gr + i * V, gv);
      rt::load_vec(w + i * V, wv);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        o[j] = r * gv[j] * wv[j] - c * xv[j];
        dw_s[i * V + j] += gv[j] * rt::to_f(rt::from_f<T>(xv[j] * r));
      }
      rt::store_vec(dx + row * d + i * V, o);
    }
  }
  for (int i = threadIdx.x; i < nvec; i += blockDim.x)
#pragma unroll
    for (int j = 0; j < V; ++j)
      dw_part[static_cast<size_t>(blockIdx.x) * d + i * V + j] = dw_s[i * V + j];
}

// dw[c] = sum over blocks of dw_part[blk, c], in block order.
template <typename T>
__global__ void rmsnorm_dw_reduce_kernel(const float* __restrict__ dw_part, T* __restrict__ dw,
                                         int nblk, int d) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  float s = 0.f;
  for (int b = 0; b < nblk; ++b) s += dw_part[static_cast<size_t>(b) * d + c];
  dw[c] = rt::from_f<T>(s);
}

template <typename T>
cudaError_t bwd_launch(const void* x, const void* w, const void* dy, void* dx, void* dw,
                       float* dw_part, long long rows, int d, int nblk, float eps,
                       cudaStream_t stream) {
  const int nvec = d / rt::Vec<T>::n;
  int threads = (nvec + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  const int per = static_cast<int>((rows + nblk - 1) / nblk);
  const int blocks = static_cast<int>((rows + per - 1) / per);
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  auto kernel = rmsnorm_bwd_kernel<T>;
  cudaError_t err = rt::set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(dy),
      static_cast<T*>(dx), dw_part, rows, d, per, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rmsnorm_dw_reduce_kernel<T><<<(d + 255) / 256, 256, 0, stream>>>(dw_part, static_cast<T*>(dw),
                                                                    blocks, d);
  return cudaGetLastError();
}

}  // namespace

// x, y: [rows, d] contiguous; w: [d].  Returns the launch's CUDA error.
extern "C" int rmsnorm_launch(const void* x, const void* w, void* y, long long rows,
                              int d, float eps, int dtype, void* stream) {
  if (rows <= 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::kBF16: return launch<__nv_bfloat16>(x, w, y, rows, d, eps, s);
    case rt::kF32: return launch<float>(x, w, y, rows, d, eps, s);
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
// `dtype`); dw_part: f32 scratch of nblk * d values, nblk >= 1 the number
// of row ranges (one block each).  Two launches: the row pass and the
// per-column sum of the blocks' dw partials.
extern "C" int rmsnorm_bwd_launch(const void* x, const void* w, const void* dy, void* dx,
                                  void* dw, void* dw_part, long long rows, int d, int nblk,
                                  float eps, int dtype, void* stream) {
  if (rows <= 0 || d <= 0) return cudaSuccess;
  if (nblk < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(dw_part);
  switch (dtype) {
    case rt::kBF16:
      return bwd_launch<__nv_bfloat16>(x, w, dy, dx, dw, part, rows, d, nblk, eps, s);
    case rt::kF32: return bwd_launch<float>(x, w, dy, dx, dw, part, rows, d, nblk, eps, s);
    default: return cudaErrorInvalidValue;
  }
}
