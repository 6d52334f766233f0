// Mamba2 SSD (state-space dual) chunked scan for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/mamba_scan.py::ssd_scan
// (_ssd_kernel).  Per (batch row b, head h), sequentially over chunks of T
// rows, with cum the inclusive cumsum of ldec = a[h] * dt over the chunk:
//   y[i]  = sum_{j<=i} (c_i . b_j) exp(cum_i - cum_j) dtx[j]
//           + exp(cum_i) (c_i . h)
//   h    <- exp(cum_{T-1}) h + sum_j b_j (x) exp(cum_{T-1} - cum_j) dtx[j]
// starting from h0 (or zeros) and writing the final h.  Everything is
// computed in f32; y is rounded to the input dtype.
//
// Bound on an H100: bytes.  At the serving shape (B 8, L 512, H 80,
// P 64, N 64, T 128) the kernel must read x (42 MB in bf16) and h0
// (10.5 MB f32) and write y and h (52.5 MB); its products need about
// 4.2 MFLOP per (b, h, chunk), some 11 GFLOP in all, so at 989 TFLOP/s the
// operations would take a third of the time the bytes take.
//
// Design.  The TPU kernel walks the chunk axis as a sequential grid
// dimension and carries h in VMEM.  Here one 256-thread block per (b, h)
// loops over the chunks itself and keeps h [N, P] in shared memory, f32,
// for the whole sequence (B*H = 640 blocks at the serving shape).  The
// block reads x [B, L, H, P] and dt [B, L, H] in their own layout and forms
// dtx = round(dt * x) itself (f32 product rounded to x's dtype, exactly
// as the reference's ops.ssd_scan forms it before its kernel) and ldec =
// a * dt, so no head-major copy of x is ever written.  Per chunk, staged in
// shared memory as f32: dtx [T, P], b and c [T, N], the cumsum (one warp's
// scan) and the decay weights.  The three products run on the CUDA cores
// from register tiles (each of the 16 x 16 threads owns rows ty + 16r and
// columns tx + 16c): S = C B^T masked and decayed [T, T] into shared
// memory, then y = S dtx + exp(cum) (C h), then the new h.  The mask is
// applied BEFORE the exponential: for j > i, cum_i - cum_j > 0 could
// overflow, and inf * 0 would poison the row.  C B^T is the same for every
// head of a batch row (one SSD group); like the Pallas kernel this one
// recomputes it per head.  Tensor cores (mma.sync / wgmma) and sharing
// C B^T across heads are later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;   // 16 x 16
constexpr int kMaxT = 128;      // largest chunk

// Shared-memory floats for a chunk padded to Tp rows (a multiple of 16).
template <int N, int P>
constexpr size_t smem_floats(int Tp) {
  return static_cast<size_t>(Tp) * P          // dtx
       + 2 * static_cast<size_t>(Tp) * (N + 1)  // b, c (padded: no bank conflicts)
       + static_cast<size_t>(N) * P           // h
       + static_cast<size_t>(Tp) * (Tp + 1)   // S = mask(C B^T) * decay
       + 2 * static_cast<size_t>(Tp);         // cum, w
}

template <typename T, int N, int P>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
           const T* __restrict__ bm, const T* __restrict__ cm, const float* __restrict__ h0,
           T* __restrict__ y, float* __restrict__ h_out, int L, int H, int chunk) {
  constexpr int V = rt::Vec<T>::n;
  constexpr int PV = P / V;
  constexpr int NV = N / V;
  constexpr int RN = N / 16, CP = P / 16;   // h tile per thread: RN x CP
  constexpr int NP = N + 1;
  extern __shared__ float smem[];
  const int Tp = (chunk + 15) / 16 * 16;
  const int TP = Tp + 1;
  const int R = Tp / 16;                    // row tiles of a chunk per thread
  float* dtx_s = smem;                      // [Tp][P]
  float* b_s = dtx_s + Tp * P;              // [Tp][N+1]
  float* c_s = b_s + Tp * NP;               // [Tp][N+1]
  float* h_s = c_s + Tp * NP;               // [N][P]
  float* s_s = h_s + N * P;                 // [Tp][Tp+1]
  float* cum_s = s_s + Tp * TP;             // [Tp]
  float* w_s = cum_s + Tp;                  // [Tp]

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float ah = a[h];
  const size_t hs = (static_cast<size_t>(b) * H + h) * N * P;   // this (b, h)'s state

  for (int i = tid; i < N * P; i += kThreads) h_s[i] = h0 != nullptr ? h0[hs + i] : 0.f;

  for (int l0 = 0; l0 < L; l0 += chunk) {
    // ---- stage the chunk: dtx = round(dt * x), b, c, ldec (pad rows 0)
    for (int i = tid; i < Tp * PV; i += kThreads) {
      const int r = i / PV, p = (i % PV) * V;
      float v[V];
      if (r < chunk) {
        const size_t row = static_cast<size_t>(b) * L + l0 + r;
        const float d = dt[row * H + h];
        rt::load_vec(x + (row * H + h) * P + p, v);
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] = rt::to_f(rt::from_f<T>(d * v[j]));
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < V; ++j) dtx_s[r * P + p + j] = v[j];
    }
    for (int i = tid; i < Tp * NV; i += kThreads) {
      const int r = i / NV, n = (i % NV) * V;
      float bv[V], cv[V];
      if (r < chunk) {
        const size_t off = (static_cast<size_t>(b) * L + l0 + r) * N + n;
        rt::load_vec(bm + off, bv);
        rt::load_vec(cm + off, cv);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) bv[j] = cv[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        b_s[r * NP + n + j] = bv[j];
        c_s[r * NP + n + j] = cv[j];
      }
    }
    for (int r = tid; r < Tp; r += kThreads)
      cum_s[r] = r < chunk ? ah * dt[(static_cast<size_t>(b) * L + l0 + r) * H + h] : 0.f;
    __syncthreads();

    // ---- inclusive cumsum of ldec (one warp, 4 rows per lane) and the
    // state-update weights w_j = exp(cum_{T-1} - cum_j)
    if (tid < 32) {
      float v[4], run = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = tid * 4 + k;
        run += r < Tp ? cum_s[r] : 0.f;
        v[k] = run;
      }
      float pre = run;   // inclusive scan of the lanes' totals
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, pre, off);
        if (tid >= off) pre += o;
      }
      pre -= run;        // exclusive
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = tid * 4 + k;
        if (r < Tp) cum_s[r] = v[k] + pre;
      }
      __syncwarp();
      const float last = cum_s[chunk - 1];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = tid * 4 + k;
        if (r < Tp) w_s[r] = r < chunk ? expf(last - cum_s[r]) : 0.f;
      }
    }
    __syncthreads();

    // ---- S[i][j] = (c_i . b_j) * exp(cum_i - cum_j) for j <= i < T, else 0
    {
      float acc[kMaxT / 16][kMaxT / 16];
#pragma unroll
      for (int r = 0; r < kMaxT / 16; ++r)
#pragma unroll
        for (int q = 0; q < kMaxT / 16; ++q) acc[r][q] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[kMaxT / 16], bv[kMaxT / 16];
#pragma unroll
        for (int r = 0; r < kMaxT / 16; ++r) {
          cv[r] = r < R ? c_s[(ty + 16 * r) * NP + n] : 0.f;
          bv[r] = r < R ? b_s[(tx + 16 * r) * NP + n] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kMaxT / 16; ++r)
#pragma unroll
          for (int q = 0; q < kMaxT / 16; ++q) acc[r][q] += cv[r] * bv[q];
      }
#pragma unroll
      for (int r = 0; r < kMaxT / 16; ++r) {
        if (r >= R) continue;
        const int i = ty + 16 * r;
#pragma unroll
        for (int q = 0; q < kMaxT / 16; ++q) {
          if (q >= R) continue;
          const int j = tx + 16 * q;
          // mask first: exp of a positive cum_i - cum_j is never taken
          s_s[i * TP + j] = (j <= i && i < chunk) ? acc[r][q] * expf(cum_s[i] - cum_s[j]) : 0.f;
        }
      }
    }
    __syncthreads();

    // ---- y = S dtx + exp(cum) (C h), rows ty + 16r, columns tx + 16c
    {
      float acc[kMaxT / 16][CP], inter[kMaxT / 16][CP];
#pragma unroll
      for (int r = 0; r < kMaxT / 16; ++r)
#pragma unroll
        for (int q = 0; q < CP; ++q) acc[r][q] = inter[r][q] = 0.f;
      for (int j = 0; j < chunk; ++j) {
        float dv[CP];
#pragma unroll
        for (int q = 0; q < CP; ++q) dv[q] = dtx_s[j * P + tx + 16 * q];
#pragma unroll
        for (int r = 0; r < kMaxT / 16; ++r) {
          if (r >= R) continue;
          const float s = s_s[(ty + 16 * r) * TP + j];
#pragma unroll
          for (int q = 0; q < CP; ++q) acc[r][q] += s * dv[q];
        }
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float hv[CP];
#pragma unroll
        for (int q = 0; q < CP; ++q) hv[q] = h_s[n * P + tx + 16 * q];
#pragma unroll
        for (int r = 0; r < kMaxT / 16; ++r) {
          if (r >= R) continue;
          const float cv = c_s[(ty + 16 * r) * NP + n];
#pragma unroll
          for (int q = 0; q < CP; ++q) inter[r][q] += cv * hv[q];
        }
      }
#pragma unroll
      for (int r = 0; r < kMaxT / 16; ++r) {
        const int i = ty + 16 * r;
        if (r >= R || i >= chunk) continue;
        const float e = expf(cum_s[i]);
        T* yr = y + ((static_cast<size_t>(b) * L + l0 + i) * H + h) * P;
#pragma unroll
        for (int q = 0; q < CP; ++q) yr[tx + 16 * q] = rt::from_f<T>(acc[r][q] + e * inter[r][q]);
      }
    }

    // ---- h <- exp(cum_{T-1}) h + sum_j b_j (x) (w_j dtx_j); rows n, columns p
    {
      float acc[RN][CP];
#pragma unroll
      for (int r = 0; r < RN; ++r)
#pragma unroll
        for (int q = 0; q < CP; ++q) acc[r][q] = 0.f;
      for (int j = 0; j < chunk; ++j) {
        const float wj = w_s[j];
        float dv[CP];
#pragma unroll
        for (int q = 0; q < CP; ++q) dv[q] = wj * dtx_s[j * P + tx + 16 * q];
#pragma unroll
        for (int r = 0; r < RN; ++r) {
          const float bv = b_s[j * NP + ty + 16 * r];
#pragma unroll
          for (int q = 0; q < CP; ++q) acc[r][q] += bv * dv[q];
        }
      }
      const float decay = expf(cum_s[chunk - 1]);
      __syncthreads();   // every thread's reads of h (the y products) are done
#pragma unroll
      for (int r = 0; r < RN; ++r)
#pragma unroll
        for (int q = 0; q < CP; ++q) {
          const int idx = (ty + 16 * r) * P + tx + 16 * q;
          h_s[idx] = decay * h_s[idx] + acc[r][q];
        }
    }
    __syncthreads();   // h is written; the next chunk may overwrite the staging
  }

  for (int i = tid; i < N * P; i += kThreads) h_out[hs + i] = h_s[i];
}

template <typename T, int N, int P>
cudaError_t launch_t(const void* x, const float* dt, const float* a, const void* b,
                     const void* c, const float* h0, void* y, float* h, int B, int L, int H,
                     int chunk, cudaStream_t stream) {
  auto kernel = ssd_kernel<T, N, P>;
  static const cudaError_t attr =   // once per process: the largest chunk's need
      rt::set_smem(kernel, smem_floats<N, P>(kMaxT) * sizeof(float));
  if (attr != cudaSuccess) return attr;
  const size_t smem = smem_floats<N, P>((chunk + 15) / 16 * 16) * sizeof(float);
  kernel<<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(b), static_cast<const T*>(c), h0,
      static_cast<T*>(y), h, L, H, chunk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int N, int P, const void* x, const float* dt, const float* a,
                     const void* b, const void* c, const float* h0, void* y, float* h, int B,
                     int L, int H, int chunk, cudaStream_t s) {
#define SSD_CASE(NN, PP)                                                               \
  if (N == NN && P == PP)                                                              \
    return launch_t<T, NN, PP>(x, dt, a, b, c, h0, y, h, B, L, H, chunk, s);
  SSD_CASE(16, 32) SSD_CASE(16, 64) SSD_CASE(32, 32) SSD_CASE(32, 64)
  SSD_CASE(64, 32) SSD_CASE(64, 64)
#undef SSD_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// x: [B, L, H, P] (dtype); dt: [B, L, H] f32; a: [H] f32; b, c: [B, L, N]
// (dtype); h0: [B, H, N, P] f32 or null (zeros); y: [B, L, H, P] (dtype);
// h: [B, H, N, P] f32.  L a multiple of chunk, 1 <= chunk <= 128; (N, P)
// one of the compiled pairs.  Returns the launch's CUDA error.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a, const void* b,
                               const void* c, const void* h0, void* y, void* h, int B, int L,
                               int H, int P, int N, int chunk, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0) return cudaSuccess;
  if (chunk < 1 || chunk > kMaxT || L % chunk != 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  const float* h0f = static_cast<const float*>(h0);
  float* hf = static_cast<float*>(h);
  switch (dtype) {
    case rt::kBF16:
      return dispatch<__nv_bfloat16>(N, P, x, dtf, af, b, c, h0f, y, hf, B, L, H, chunk, s);
    case rt::kF32:
      return dispatch<float>(N, P, x, dtf, af, b, c, h0f, y, hf, B, L, H, chunk, s);
    default: return cudaErrorInvalidValue;
  }
}
