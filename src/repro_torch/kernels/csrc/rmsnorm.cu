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
cudaError_t launch(const void* x, const void* w, void* y, long long rows, int d,
                   float eps, cudaStream_t stream) {
  const int nvec = d / rt::Vec<T>::n;
  int threads = (nvec + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  rmsnorm_kernel<T><<<static_cast<unsigned>(rows), threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), d, eps);
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
