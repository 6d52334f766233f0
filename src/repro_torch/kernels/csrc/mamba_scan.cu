// Mamba2 SSD (state-space dual) chunked scan for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/mamba_scan.py::ssd_scan
// (_ssd_kernel).  Per (batch row b, head h), sequentially over chunks of T
// rows, with cum the inclusive cumsum of ldec = a[h] * dt over the chunk:
//   y[i]  = sum_{j<=i} (c_i . b_j) exp(cum_i - cum_j) dtx[j]
//           + exp(cum_i) (c_i . h)
//   h    <- exp(cum_{T-1}) h + sum_j b_j (x) exp(cum_{T-1} - cum_j) dtx[j]
// starting from h0 (or zeros) and writing the final h; y is rounded to
// the input dtype.
//
// Bound on an H100: bytes.  At the serving shape (B 8, L 512, H 80,
// P 64, N 64, T 128) the kernel must read x (42 MB in bf16) and h0
// (10.5 MB f32) and write y and h (52.5 MB), ~32 us at 3.35 TB/s; its
// products need about 11 GFLOP, ~11 us at the bf16 tensor-core peak.  On
// the CUDA cores (67 TFLOP/s f32, and less from shared memory) the same
// products take several times the bytes' time: the products must run on
// the tensor cores.
//
// bf16 design (namespace tc).  One 128-thread block per (batch row b, a
// group of up to 4 heads, 32 of the P columns), walking the chunks in
// order; the planner (mamba_scan.py::ssd_plan) takes the largest group
// that still gives every SM a block: 4 heads at B 8 (320 blocks), 1 at
// B 1 (160 blocks, the P split fills the card).  b and c are shared by
// every head of a batch row (one SSD group), so G = C B^T is formed once
// per chunk for the block's heads, on the tensor cores (mma.sync
// m16n8k16, bf16 in, f32 accumulate: the exact f32 products of the bf16
// inputs), and kept in registers: warp w owns row blocks w and 7 - w of
// the chunk (16 rows each, their causal column tiles, so the four warps
// do equal work).  Per head, in f32: S = G * exp(cum_i - cum_j), the mask
// applied before the exponential, rounded to bf16 as an A operand; y =
// exp(cum) (C h) + S dtx on the tensor cores (dtx is exact in bf16; h
// goes in rounded to bf16: it feeds only y, a bf16 output).  The state
// update h <- exp(cum_{T-1}) h + B^T (w (.) dtx) must stay accurate to f32
// (h is carried across prefill chunks and checked to 1e-3): w (.) dtx is
// split into a bf16 high part and a bf16 low part, two products on the
// tensor cores (hi + lo keeps ~16 bits, errors ~2^-17 of each term; one
// bf16 operand would give 2^-9 per term over 512 steps).  The CUDA cores
// keep only the elementwise work: the cumsum (one warp per head), the
// exponentials, dtx = round(dt x).  h [N, 32] stays in shared memory, f32,
// for the whole sequence.  Shared memory ~108 KB at 4 heads (two blocks
// per SM): the chunk's c and b, x of each head, h, the per-row weights.
// Prefetch: the next chunk's c is copied (cp.async) once G and C's
// fragments are in registers, the next x and dt of a head once its state
// update is done, the next b after the last head; so loads overlap the
// block's products, and the second block on the SM covers the rest.
//
// f32 keeps the FMA body below (one 256-thread block per (b, h), every
// product on the CUDA cores from shared memory) by an explicit dispatch on
// dtype: a TF32 product would break the f32 tests' tolerance.  Its design:
// the block reads x [B, L, H, P] and dt [B, L, H] in their own layout and
// forms dtx = round(dt * x) itself (f32 product rounded to x's dtype,
// exactly as the reference's ops.ssd_scan forms it before its kernel) and
// ldec = a * dt, so no head-major copy of x is ever written.  Per chunk,
// staged in shared memory as f32: dtx [T, P], b and c [T, N], the cumsum
// (one warp's scan) and the decay weights.  The three products run from
// register tiles (each of the 16 x 16 threads owns rows ty + 16r and
// columns tx + 16c): S = C B^T masked and decayed [T, T] into shared
// memory, then y = S dtx + exp(cum) (C h), then the new h.  The mask is
// applied BEFORE the exponential: for j > i, cum_i - cum_j > 0 could
// overflow, and inf * 0 would poison the row.
#include "common.cuh"
#include "mma.cuh"

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

// ====================================================== bf16: tensor cores ====
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4, kThreads = 32 * kWarps;
constexpr int kCols = 32;        // head-dim columns per block (a P slice)
constexpr int kMaxHeads = 4;     // heads per block (the planner's head group)
constexpr int kRows = 128;       // rows of the largest chunk
constexpr int kHP = kCols + 4;   // h row pitch (f32): C h's fragment reads hit 32 banks
constexpr float kLog2e = 1.4426950408889634f;

// Element offset of 16-byte chunk c of row r in a tile of R16 chunks a
// row, swizzled so that the 8 rows one ldmatrix reads at a chunk lie in 8
// different bank groups.
template <int R16>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int sh = R16 == 8 ? 0 : R16 == 4 ? 1 : 2;
  return (r * R16 + (c ^ ((r >> sh) & (R16 - 1)))) * 8;
}

// Shared-memory layout of a block with `hg` heads (offsets in bytes).
struct Smem {
  size_t c, b, x, h, dt, cum2, ecum, wgt, dec, total;
  __host__ __device__ Smem(int N, int hg) {
    c = 0;
    b = c + static_cast<size_t>(kRows) * N * sizeof(bf16);
    x = b + static_cast<size_t>(kRows) * N * sizeof(bf16);
    h = x + static_cast<size_t>(hg) * kRows * kCols * sizeof(bf16);
    dt = h + static_cast<size_t>(hg) * N * kHP * sizeof(float);
    cum2 = dt + static_cast<size_t>(hg) * kRows * sizeof(float);
    ecum = cum2 + static_cast<size_t>(hg) * kRows * sizeof(float);
    wgt = ecum + static_cast<size_t>(hg) * kRows * sizeof(float);
    dec = wgt + static_cast<size_t>(hg) * kRows * sizeof(float);
    total = dec + static_cast<size_t>(hg) * sizeof(float);
  }
};

// An f32 pair as bf16 pairs: hl[0] the rounded values, hl[1] the rounded
// remainders.  hl[0] + hl[1] keeps ~16 significant bits (error ~2^-17 of
// each value), so a product taken twice, once per part, is accurate to
// about f32's 2^-17 rather than bf16's 2^-9.
__device__ __forceinline__ void split_bf16(uint32_t (&hl)[2], float a, float b) {
  hl[0] = mma::pack_bf16(a, b);
  const float2 r = mma::unpack_bf16(hl[0]);
  hl[1] = mma::pack_bf16(a - r.x, b - r.y);
}

// A fragments (mma m16n8k16) of C's row block rb, all N/16 k-steps.
template <int N>
__device__ __forceinline__ void c_frags(uint32_t (&ca)[N / 16][4], const bf16* c_s, int rb) {
  const int lane = threadIdx.x & 31, mi = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    mma::ldsm_x4(ca[kk], c_s + swz<N / 8>(16 * rb + (mi & 1) * 8 + (lane & 7), 2 * kk + (mi >> 1)));
}

// G = C B^T for row block rb: n-tiles 0 .. 2 rb + 1 (the causal part);
// the others are left unset and never read.
template <int N, int NTM>
__device__ __forceinline__ void gram(float (&g)[NTM][4], const uint32_t (&ca)[N / 16][4],
                                     const bf16* b_s, int rb) {
  const int lane = threadIdx.x & 31, mi = lane >> 3;
#pragma unroll
  for (int np = 0; np < NTM / 2; ++np) {
    if (np > rb) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) g[2 * np][e] = g[2 * np + 1][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      uint32_t bb[4];
      mma::ldsm_x4(bb, b_s + swz<N / 8>(8 * (2 * np + (mi >> 1)) + (lane & 7), 2 * kk + (mi & 1)));
      mma::mma_bf16(g[2 * np], ca[kk], bb[0], bb[1]);
      mma::mma_bf16(g[2 * np + 1], ca[kk], bb[2], bb[3]);
    }
  }
}

// One head's output rows of row block rb (rows i0 = 16 rb + g, i1 = i0 +
// 8; 32 columns): exp(cum_i) (C h)_i + sum_{j <= i} S_ij dtx_j with S =
// G * exp(cum_i - cum_j) masked before the exponential, rounded to bf16;
// h rounded to bf16.  Stores rows < T.
template <int N, int NTM>
__device__ __forceinline__ void y_rows(const float (&g)[NTM][4], const uint32_t (&ca)[N / 16][4],
                                       int rb, int T, const float* h_s, const bf16* x_s,
                                       const float* cum2, const float* ecum, bf16* __restrict__ y,
                                       size_t row_stride) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, gq = lane >> 2, qd = lane & 3;
  const int i0 = 16 * rb + gq, i1 = i0 + 8;
  float acc[4][4] = {};
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float* hp = h_s + (16 * kk + 2 * qd) * kHP + 8 * nt + gq;
      uint32_t b0[2], b1[2];
      split_bf16(b0, hp[0], hp[kHP]);
      split_bf16(b1, hp[8 * kHP], hp[9 * kHP]);
      mma::mma_bf16(acc[nt], ca[kk], b0[0], b1[0]);
      mma::mma_bf16(acc[nt], ca[kk], b0[1], b1[1]);
    }
  const float e0 = ecum[i0], e1 = ecum[i1];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    acc[nt][0] *= e0;
    acc[nt][1] *= e0;
    acc[nt][2] *= e1;
    acc[nt][3] *= e1;
  }
  const float ci0 = cum2[i0], ci1 = cum2[i1];
  const bool r0 = i0 < T, r1 = i1 < T;
#pragma unroll
  for (int ks = 0; ks < NTM / 2; ++ks) {
    if (ks > rb) break;
    uint32_t sa[4], sl[4];   // S's high and low bf16 parts
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int nt = 2 * ks + half, j = 16 * ks + 8 * half + 2 * qd;
      const float2 cj = *reinterpret_cast<const float2*>(cum2 + j);
      // mask first: exp of a positive cum_i - cum_j is never used
      const float s00 = r0 && j <= i0 ? g[nt][0] * exp2f(ci0 - cj.x) : 0.f;
      const float s01 = r0 && j + 1 <= i0 ? g[nt][1] * exp2f(ci0 - cj.y) : 0.f;
      const float s10 = r1 && j <= i1 ? g[nt][2] * exp2f(ci1 - cj.x) : 0.f;
      const float s11 = r1 && j + 1 <= i1 ? g[nt][3] * exp2f(ci1 - cj.y) : 0.f;
      uint32_t p0[2], p1[2];
      split_bf16(p0, s00, s01);
      split_bf16(p1, s10, s11);
      sa[2 * half] = p0[0];
      sl[2 * half] = p0[1];
      sa[2 * half + 1] = p1[0];
      sl[2 * half + 1] = p1[1];
    }
#pragma unroll
    for (int cp = 0; cp < 2; ++cp) {
      uint32_t xb[4];
      mma::ldsm_x4_t(xb, x_s + swz<kCols / 8>(16 * ks + (mi & 1) * 8 + (lane & 7), 2 * cp + (mi >> 1)));
      mma::mma_bf16(acc[2 * cp], sa, xb[0], xb[1]);
      mma::mma_bf16(acc[2 * cp], sl, xb[0], xb[1]);
      mma::mma_bf16(acc[2 * cp + 1], sa, xb[2], xb[3]);
      mma::mma_bf16(acc[2 * cp + 1], sl, xb[2], xb[3]);
    }
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int c = 8 * nt + 2 * qd;
    if (r0)
      *reinterpret_cast<__nv_bfloat162*>(y + i0 * row_stride + c) =
          __floats2bfloat162_rn(acc[nt][0], acc[nt][1]);
    if (r1)
      *reinterpret_cast<__nv_bfloat162*>(y + i1 * row_stride + c) =
          __floats2bfloat162_rn(acc[nt][2], acc[nt][3]);
  }
}

// One head's state update by this warp, columns 8 warp .. 8 warp + 7 of
// the slice, all N rows: h <- exp(cum_{T-1}) h + B^T (w (.) dtx), in f32.
// w (.) dtx is an f32 operand: it goes in as a bf16 high part and a bf16
// low part (two products; hi + lo keeps ~16 bits), B is exact in bf16.
template <int N>
__device__ __forceinline__ void state_update(float* h_s, const bf16* x_s, const bf16* b_s,
                                             const float* wgt, float decay, int nks) {
  constexpr int MT = N / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, mi = lane >> 3;
  const int gq = lane >> 2, qd = lane & 3, p = 8 * warp + 2 * qd;
  float acc[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const float2 a = *reinterpret_cast<const float2*>(h_s + (16 * i + gq) * kHP + p);
    const float2 c = *reinterpret_cast<const float2*>(h_s + (16 * i + gq + 8) * kHP + p);
    acc[i][0] = decay * a.x;
    acc[i][1] = decay * a.y;
    acc[i][2] = decay * c.x;
    acc[i][3] = decay * c.y;
  }
  for (int ks = 0; ks < nks; ++ks) {
    uint32_t xb[2];
    mma::ldsm_x2_t(xb, x_s + swz<kCols / 8>(16 * ks + (mi & 1) * 8 + (lane & 7), warp));
    const float2 w0 = *reinterpret_cast<const float2*>(wgt + 16 * ks + 2 * qd);
    const float2 w1 = *reinterpret_cast<const float2*>(wgt + 16 * ks + 8 + 2 * qd);
    const float2 d0 = mma::unpack_bf16(xb[0]), d1 = mma::unpack_bf16(xb[1]);
    uint32_t v0[2], v1[2];
    split_bf16(v0, d0.x * w0.x, d0.y * w0.y);
    split_bf16(v1, d1.x * w1.x, d1.y * w1.y);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      uint32_t ba[4];   // B^T rows 16 i .., k = chunk rows 16 ks ..
      mma::ldsm_x4_t(ba, b_s + swz<N / 8>(16 * ks + (mi >> 1) * 8 + (lane & 7), 2 * i + (mi & 1)));
      mma::mma_bf16(acc[i], ba, v0[0], v1[0]);
      mma::mma_bf16(acc[i], ba, v0[1], v1[1]);
    }
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    *reinterpret_cast<float2*>(h_s + (16 * i + gq) * kHP + p) = make_float2(acc[i][0], acc[i][1]);
    *reinterpret_cast<float2*>(h_s + (16 * i + gq + 8) * kHP + p) =
        make_float2(acc[i][2], acc[i][3]);
  }
}

// One block: batch row blockIdx.y, heads [hg blockIdx.x, + hg) (fewer in
// the last group), head-dim columns [32 blockIdx.z, + 32); walks the
// chunks in order (see the head note).
template <int N>
__global__ void __launch_bounds__(kThreads, 2)
ssd_kernel(const bf16* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
           const bf16* __restrict__ bm, const bf16* __restrict__ cm, const float* __restrict__ h0,
           bf16* __restrict__ y, float* __restrict__ h_out, int L, int H, int P, int chunk,
           int hg) {
  constexpr int RN = N / 8;   // 16-byte chunks of a b / c row
  constexpr int KN = N / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem lay(N, hg);
  bf16* c_s = reinterpret_cast<bf16*>(smem + lay.c);
  bf16* b_s = reinterpret_cast<bf16*>(smem + lay.b);
  bf16* x_s = reinterpret_cast<bf16*>(smem + lay.x);      // [hg][kRows][kCols]
  float* h_s = reinterpret_cast<float*>(smem + lay.h);    // [hg][N][kHP]
  float* dt_s = reinterpret_cast<float*>(smem + lay.dt);  // [hg][kRows]
  float* cum2_s = reinterpret_cast<float*>(smem + lay.cum2);
  float* ecum_s = reinterpret_cast<float*>(smem + lay.ecum);
  float* wgt_s = reinterpret_cast<float*>(smem + lay.wgt);
  float* dec_s = reinterpret_cast<float*>(smem + lay.dec);

  const int b = blockIdx.y, hf = blockIdx.x * hg, p0 = blockIdx.z * kCols;
  const int nh = min(hg, H - hf);
  const int T = chunk, Tp = (T + 15) / 16 * 16, nrb = Tp / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rb0 = warp, rb1 = 7 - warp;   // this warp's row blocks (balanced causal work)
  const bool on0 = rb0 < nrb, on1 = rb1 < nrb;

  auto load_bc = [&](bf16* dst, const bf16* src, int l0) {   // rows l0 .. of b or c
    for (int i = threadIdx.x; i < Tp * RN; i += kThreads) {
      const int r = i / RN, c = i % RN;
      const bool ok = r < T;
      mma::cp_async16(dst + swz<RN>(r, c),
                      ok ? src + (static_cast<size_t>(b) * L + l0 + r) * N + c * 8 : src, ok);
    }
  };
  auto load_x = [&](int hh, int l0) {   // head hf + hh: x rows l0 .. (our columns) and dt
    const int hd = hf + hh;
    bf16* dst = x_s + hh * kRows * kCols;
    for (int i = threadIdx.x; i < Tp * (kCols / 8); i += kThreads) {
      const int r = i / (kCols / 8), c = i % (kCols / 8);
      const bool ok = r < T;
      mma::cp_async16(dst + swz<kCols / 8>(r, c),
                      ok ? x + ((static_cast<size_t>(b) * L + l0 + r) * H + hd) * P + p0 + c * 8
                         : x,
                      ok);
    }
    for (int r = threadIdx.x; r < Tp; r += kThreads) {
      const bool ok = r < T;
      mma::cp_async4(dt_s + hh * kRows + r, ok ? dt + (static_cast<size_t>(b) * L + l0 + r) * H + hd : dt,
                     ok);
    }
  };

  for (int hh = 0; hh < nh; ++hh) {
    const size_t hs = (static_cast<size_t>(b) * H + hf + hh) * N;
    for (int i = threadIdx.x; i < N * kCols; i += kThreads) {
      const int n = i / kCols, p = i % kCols;
      h_s[(hh * N + n) * kHP + p] = h0 != nullptr ? h0[(hs + n) * P + p0 + p] : 0.f;
    }
  }
  load_bc(c_s, cm, 0);
  load_bc(b_s, bm, 0);
  for (int hh = 0; hh < nh; ++hh) load_x(hh, 0);
  mma::cp_async_commit();

  for (int l0 = 0; l0 < L; l0 += T) {
    const bool more = l0 + T < L;
    mma::cp_async_wait<0>();
    __syncthreads();   // the chunk's b, c, x, dt have landed

    // per head (warp hh): the inclusive cumsum of ldec = a dt over the
    // chunk (rows past T add 0), in log2 units for S, exp(cum) for C h,
    // the state weights exp(cum_{T-1} - cum_j) and the decay exp(cum_{T-1})
    if (warp < nh) {
      const int hh = warp;
      const float ah = a[hf + hh];
      float v[4], run = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = lane * 4 + k;
        run += r < Tp ? ah * dt_s[hh * kRows + r] : 0.f;
        v[k] = run;
      }
      float pre = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, pre, off);
        if (lane >= off) pre += o;
      }
      pre -= run;
      const int kl = (T - 1) & 3;   // row T - 1 is lane (T - 1) / 4's value kl
      const float mine = kl == 0 ? v[0] : kl == 1 ? v[1] : kl == 2 ? v[2] : v[3];
      const float last = __shfl_sync(0xffffffffu, mine + pre, (T - 1) >> 2);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = lane * 4 + k;
        if (r < Tp) {
          const float cum = v[k] + pre;
          cum2_s[hh * kRows + r] = cum * kLog2e;
          ecum_s[hh * kRows + r] = expf(cum);
          wgt_s[hh * kRows + r] = r < T ? expf(last - cum) : 0.f;
        }
      }
      if (lane == 0) dec_s[hh] = expf(last);
    }
    // dtx = round(dt x) in place (f32 product rounded to bf16, as the
    // reference forms it)
    for (int i = threadIdx.x; i < nh * Tp * (kCols / 8); i += kThreads) {
      const int hh = i / (Tp * (kCols / 8)), r = (i / (kCols / 8)) % Tp, c = i % (kCols / 8);
      uint4* at = reinterpret_cast<uint4*>(x_s + hh * kRows * kCols + swz<kCols / 8>(r, c));
      uint4 u = *at;
      const float d = dt_s[hh * kRows + r];
      uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = mma::unpack_bf16(w[e]);
        w[e] = mma::pack_bf16(d * f.x, d * f.y);
      }
      *at = u;
    }
    __syncthreads();

    // G = C B^T once for every head of the block (registers), and C's A
    // fragments for C h; then c_s is free for the next chunk's c
    float g0[8][4], g1[16][4];
    uint32_t ca0[KN][4], ca1[KN][4];
    if (on0) {
      c_frags<N>(ca0, c_s, rb0);
      gram<N>(g0, ca0, b_s, rb0);
    }
    if (on1) {
      c_frags<N>(ca1, c_s, rb1);
      gram<N>(g1, ca1, b_s, rb1);
    }
    __syncthreads();
    if (more) {
      load_bc(c_s, cm, l0 + T);
      mma::cp_async_commit();
    }

    for (int hh = 0; hh < nh; ++hh) {
      const bf16* xs = x_s + hh * kRows * kCols;
      float* hs = h_s + hh * N * kHP;
      bf16* yb = y + ((static_cast<size_t>(b) * L + l0) * H + hf + hh) * P + p0;
      const size_t stride = static_cast<size_t>(H) * P;
      if (on0)
        y_rows<N>(g0, ca0, rb0, T, hs, xs, cum2_s + hh * kRows, ecum_s + hh * kRows, yb, stride);
      if (on1)
        y_rows<N>(g1, ca1, rb1, T, hs, xs, cum2_s + hh * kRows, ecum_s + hh * kRows, yb, stride);
      __syncthreads();   // every warp has read this head's h
      state_update<N>(hs, xs, b_s, wgt_s + hh * kRows, dec_s[hh], nrb);
      __syncthreads();   // h is written; this head's x is free
      if (more) {
        load_x(hh, l0 + T);
        mma::cp_async_commit();
      }
    }
    if (more) {
      load_bc(b_s, bm, l0 + T);
      mma::cp_async_commit();
    }
  }

  for (int hh = 0; hh < nh; ++hh) {
    const size_t hs = (static_cast<size_t>(b) * H + hf + hh) * N;
    for (int i = threadIdx.x; i < N * kCols; i += kThreads) {
      const int n = i / kCols, p = i % kCols;
      h_out[(hs + n) * P + p0 + p] = h_s[(hh * N + n) * kHP + p];
    }
  }
}

template <int N>
cudaError_t launch(const void* x, const float* dt, const float* a, const void* b, const void* c,
                   const float* h0, void* y, float* h, int B, int L, int H, int P, int chunk,
                   int hg, cudaStream_t stream) {
  if (hg < 1 || hg > kMaxHeads || P % kCols != 0) return cudaErrorInvalidValue;
  auto kernel = ssd_kernel<N>;
  static const cudaError_t attr =   // once per process: the largest head group's need
      rt::set_smem(kernel, Smem(N, kMaxHeads).total);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((H + hg - 1) / hg, B, P / kCols);
  kernel<<<grid, kThreads, Smem(N, hg).total, stream>>>(
      static_cast<const bf16*>(x), dt, a, static_cast<const bf16*>(b),
      static_cast<const bf16*>(c), h0, static_cast<bf16*>(y), h, L, H, P, chunk, hg);
  return cudaGetLastError();
}

cudaError_t dispatch(int N, const void* x, const float* dt, const float* a, const void* b,
                     const void* c, const float* h0, void* y, float* h, int B, int L, int H,
                     int P, int chunk, int hg, cudaStream_t s) {
  switch (N) {
    case 16: return launch<16>(x, dt, a, b, c, h0, y, h, B, L, H, P, chunk, hg, s);
    case 32: return launch<32>(x, dt, a, b, c, h0, y, h, B, L, H, P, chunk, hg, s);
    case 64: return launch<64>(x, dt, a, b, c, h0, y, h, B, L, H, P, chunk, hg, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

// ================================================================ backward ====
// The gradient of the scan above (the function ref.ssd_scan), which the
// Pallas kernel does not have: it replaces JAX autodiff of
// repro/kernels/ref.py::ssd_chunked.  Its plain version is
// kernels/ref.py::ssd_scan_backward, whose docstring derives the
// recurrence both bodies below follow.  Per chunk k, with cum the
// inclusive cumsum of ldec = a dt, w = exp(cum_{T-1} - cum), decay =
// exp(cum_{T-1}), h_k the state before the chunk and dh_k the gradient of
// the state after it, only two [N, P] recurrences cross chunks:
//   h_{k+1} = decay_k h_k + s_k,        s_k = B_k^T (w (.) dtx_k)
//   dh_{k-1} = decay_k dh_k + u_k,      u_k = C_k^T (exp(cum) (.) dy_k)
// and s_k, u_k depend on chunk k alone; given h_k and dh_k every other
// gradient is local to its chunk.
//
// Bound on an H100: bytes.  At the training shape (B 4, L 2048, H 80,
// P 64, N 64, T 128) it must read x and dy (2 x 84 MB in bf16), dt, b, c
// and write dx (84 MB), ddt, db, dc: ~261 MB, ~78 us at 3.35 TB/s; its
// products need about 54 GFLOP, ~55 us at the bf16 tensor-core peak.
//
// bf16 (namespace bwdtc): chunk-parallel, products on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulate).  Four launches:
//  (a) ssd_bwd_states, one 128-thread block per (batch row, chunk, head
//      group): s_k and u_k of each head into f32 scratch, and decay_k.
//  (b) ssd_bwd_pass, one thread per (row, head, 8 state entries): both
//      recurrences in f32 over the chunks, in place: h_k over s_k and dh_k
//      over u_k, each stored as 8 bf16 high parts then their 8 bf16
//      remainders (the A/B operand form the next launch copies as is),
//      and dh0.
//  (c) ssd_bwd_chunk, one 128-thread block per (row, chunk, head group),
//      two resident per SM (~112 KB of shared memory at 7 heads): every
//      chunk-local gradient (below).
//  (d) ssd_bwd_sums: dB, dC summed over the head groups, dA over rows
//      and chunks, in a fixed order.
// What this does about the FMA body's limits (one serial block per (row,
// head), 320 blocks of 226 KB at the training shape, every product on the
// FMA pipes, the chunk state read strided from device memory, per-head
// dB/dC partials of [B, H, L, N]):
//  - parallel over chunks: (a) and (c) run B (L/T) ceil(H/hg) blocks
//    (768 at the training shape, hg 7 from mamba_scan.py::ssd_bwd_plan);
//    only (b) walks the chunks in order, and it is f32 elementwise work.
//  - every product on the tensor cores.  b and c are shared by every head
//    (one SSD group), so in (c) G^T = B C^T is formed once per chunk for
//    the block's heads (kept in shared memory, f32, each thread its own
//    fragments), dG = sum_h dS_h (.) exp(cum_i - cum_j) is summed over the
//    block's heads in registers first, and dB_intra = dG^T C and
//    dC_intra = dG B are one product each per chunk, not per head.  The
//    dB/dC partials shrink to [B, ceil(H/hg), L, N].
//  - the chunk states are staged in shared memory by cp.async, 16-byte
//    coalesced copies of the high/low planes (b) wrote; nothing is read
//    strided from device memory.
//  - operands that must keep f32 accuracy go in as a bf16 high part plus
//    a bf16 low part, two products (hi + lo keeps ~16 bits): w (.) dtx
//    and exp(cum) (.) dy in (a) (they feed the recurrences over every
//    chunk), h_k and dh_k wherever they are an operand, S^T = G^T (.)
//    exp(cum_i - cum_j) in d(dtx) = S^T dy and the summed dG in dB_intra
//    and dC_intra (at the training shape, PERF.md §6: without the S
//    split dx, without the dG split db leaves 2e-2 abs + rel of the plain
//    version, as test_ssd_scan_backward_kernel_elementwise checks; the
//    two cost ~4% of the call).  dy,
//    dtx = round(dt x), b and c are exact in bf16, and exp(cum) and w
//    scale the rows of a product after it, so they are never operands in
//    (c).  The mask is applied before the exponential.
// (c) in detail, per block: G^T tiles; then per head, warp w owning row
// blocks w and 7 - w (16 rows each: equal causal work): d(dtx) = S^T dy +
// w (.) (B dh) -> dx and sum_p d(dtx) x; dS^T = dtx dy^T -> dG and the row
// and column sums of dS (.) S; the w term sum_p dtx (.) (B dh).  Then dG
// goes to shared memory as high/low planes for dC_intra (read
// transposed).  A second pass over the heads forms dB_inter = w (.) (dtx
// dh^T) and dC_inter = exp(cum) (.) (dy h^T), the C h term of dcum from
// the latter (c . (dy h^T)), the decay term decay sum(dh (.) h), and
// d(ldec) as the reverse cumsum of dcum, so ddt and dA's part.
// Scratch (f32 words): s/h and u/dh [B, L/T, H, N, P] (84 MB each at the
// training shape), decay and dA parts [B, L/T, H], dB and dC parts [B,
// ceil(H/hg), L, N] (25 MB each at hg 7): ~218 MB, against the FMA
// body's 420 MB.  No atomics anywhere: two launches give the same bits.
// Measured (PERF.md §6): ~1.03 ms a call at the training shape against
// the FMA body's 13.3, far from the 0.078 ms bound still: (c) takes ~0.69
// ms at ~79 TFLOP/s, latency-bound at 8 warps a SM (255 registers, two
// 4-warp blocks) with each head's copies overlapping only the other
// block's products; (a) and (b) move their f32 scratch at ~2.2 TB/s.
//
// f32 keeps the FMA body (namespace bwd) by an explicit dispatch on dtype
// (a TF32 product would break the f32 tolerances): one 256-thread block
// per (batch row, head), the 16 x 16 register tiles of the f32 forward.
// The block first walks the chunks forward and writes the state before
// each into a scratch [B, H, L / T, N, P] f32, then walks them in reverse
// carrying dh [N, P] in shared memory, and per chunk (staged as f32: dtx,
// dy, b, c, the cumsum, and S = (C B^T) (.) exp(cum_i - cum_j) in a [T, T]
// tile) forms d(dtx), dx and ddt, dS and from it dG and the decay terms,
// the per-head parts of dB and dC [B, H, L, N], and the new dh; a second
// launch sums the heads' and rows' parts in order.
namespace bwd {

constexpr int kThreads = 256;   // 16 x 16

// Shared-memory floats of a chunk padded to Tp rows.
template <int N, int P>
constexpr size_t smem_floats(int Tp) {
  return static_cast<size_t>(Tp) * (P + 1)       // dtx
       + static_cast<size_t>(Tp) * P             // dy
       + 2 * static_cast<size_t>(Tp) * (N + 1)   // b, c
       + static_cast<size_t>(N) * (P + 1)        // dh (the state in the first walk)
       + static_cast<size_t>(Tp) * (Tp + 1)      // S, then dG
       + 16 * static_cast<size_t>(Tp)            // column partials of dS (.) S
       + 7 * static_cast<size_t>(Tp) + 8;        // per-row vectors, a reduction
}

// Sum over the 16 threads (tx) that share a row of the 16 x 16 layout.
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int N, int P>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a, const float* __restrict__ bm,
               const float* __restrict__ cm, const float* __restrict__ h0,
               const float* __restrict__ dy, const float* __restrict__ dh_final,
               float* __restrict__ hs, float* __restrict__ dx, float* __restrict__ ddt,
               float* __restrict__ dbp, float* __restrict__ dcp, float* __restrict__ dap,
               float* __restrict__ dh0, int L, int H, int chunk) {
  constexpr int V = rt::Vec<float>::n, PV = P / V, NV = N / V;
  constexpr int PP = P + 1, NP = N + 1;
  constexpr int CP = P / 16, CN = N / 16, RN = N / 16;
  constexpr int RT = kMaxT / 16;            // row tiles of the largest chunk
  extern __shared__ float smem[];
  const int Tp = (chunk + 15) / 16 * 16, TP = Tp + 1, R = Tp / 16;
  float* dtx_s = smem;                      // [Tp][PP]
  float* dy_s = dtx_s + Tp * PP;            // [Tp][P]
  float* b_s = dy_s + Tp * P;               // [Tp][NP]
  float* c_s = b_s + Tp * NP;               // [Tp][NP]
  float* dh_s = c_s + Tp * NP;              // [N][PP]
  float* s_s = dh_s + N * PP;               // [Tp][TP]
  float* colq_s = s_s + Tp * TP;            // [16][Tp]
  float* cum_s = colq_s + 16 * Tp;          // [Tp] each:
  float* ecum_s = cum_s + Tp;               //   exp(cum)
  float* w_s = ecum_s + Tp;                 //   exp(cum_last - cum)
  float* dcum_s = w_s + Tp;                 //   row sums of dS (.) S
  float* xd_s = dcum_s + Tp;                //   sum_p d(dtx) x
  float* yi_s = xd_s + Tp;                  //   the C h term of dcum
  float* wdw_s = yi_s + Tp;                 //   w (.) dw
  float* red_s = wdw_s + Tp;                // [8]: the decay term by warp

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4, lane = tid & 31;
  const int nc = L / chunk;
  const float ah = a[h];
  const size_t bh = static_cast<size_t>(b) * H + h;
  const size_t st = bh * N * P;             // this (b, h)'s state

  // dtx = dt x, b, c, ldec of the chunk at l0 (and dy), pad rows 0;
  // then the cumsum, exp(cum) and the state weights w
  auto stage = [&](int l0, bool with_dy) {
    for (int i = tid; i < Tp * PV; i += kThreads) {
      const int r = i / PV, p = (i % PV) * V;
      float v[V], g[V];
      if (r < chunk) {
        const size_t row = static_cast<size_t>(b) * L + l0 + r;
        const float d = dt[row * H + h];
        rt::load_vec(x + (row * H + h) * P + p, v);
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] *= d;
        if (with_dy) rt::load_vec(dy + (row * H + h) * P + p, g);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] = g[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        dtx_s[r * PP + p + j] = v[j];
        if (with_dy) dy_s[r * P + p + j] = g[j];
      }
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
    if (tid < 32) {   // inclusive cumsum, 4 rows a lane (as the forward)
      float v[4], run = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = tid * 4 + k;
        run += r < Tp ? cum_s[r] : 0.f;
        v[k] = run;
      }
      float pre = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, pre, off);
        if (tid >= off) pre += o;
      }
      pre -= run;
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
        if (r < Tp) {
          ecum_s[r] = r < chunk ? expf(cum_s[r]) : 0.f;
          w_s[r] = r < chunk ? expf(last - cum_s[r]) : 0.f;
        }
      }
    }
    __syncthreads();
  };

  // ---- first walk: the state before every chunk, into hs
  for (int i = tid; i < N * P; i += kThreads)
    dh_s[(i / P) * PP + i % P] = h0 != nullptr ? h0[st + i] : 0.f;
  __syncthreads();
  for (int k = 0; k < nc; ++k) {
    float* out = hs + (bh * nc + k) * N * P;
    for (int i = tid; i < N * P; i += kThreads) out[i] = dh_s[(i / P) * PP + i % P];
    if (k + 1 == nc) break;
    stage(k * chunk, false);
    float acc[RN][CP] = {};
    for (int j = 0; j < chunk; ++j) {
      float dv[CP];
#pragma unroll
      for (int q = 0; q < CP; ++q) dv[q] = w_s[j] * dtx_s[j * PP + tx + 16 * q];
#pragma unroll
      for (int r = 0; r < RN; ++r) {
        const float bv = b_s[j * NP + ty + 16 * r];
#pragma unroll
        for (int q = 0; q < CP; ++q) acc[r][q] += bv * dv[q];
      }
    }
    const float decay = expf(cum_s[chunk - 1]);
#pragma unroll
    for (int r = 0; r < RN; ++r)
#pragma unroll
      for (int q = 0; q < CP; ++q) {
        float* e = dh_s + (ty + 16 * r) * PP + tx + 16 * q;
        *e = decay * *e + acc[r][q];
      }
    __syncthreads();   // the state is whole before it is written out
  }
  __syncthreads();

  // ---- reverse walk, carrying dh
  for (int i = tid; i < N * P; i += kThreads)
    dh_s[(i / P) * PP + i % P] = dh_final != nullptr ? dh_final[st + i] : 0.f;
  float da_lane = 0.f;   // warp 0: this lane's rows' d(ldec) dt, summed over chunks
  for (int k = nc - 1; k >= 0; --k) {
    const int l0 = k * chunk;
    stage(l0, true);
    const float* hp = hs + (bh * nc + k) * N * P;   // the state before this chunk
    const float decay = expf(cum_s[chunk - 1]);

    // S[i][j] = (c_i . b_j) exp(cum_i - cum_j) for j <= i < T, else 0
    {
      float acc[RT][RT] = {};
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[RT], bv[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          cv[r] = r < R ? c_s[(ty + 16 * r) * NP + n] : 0.f;
          bv[r] = r < R ? b_s[(tx + 16 * r) * NP + n] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int q = 0; q < RT; ++q) acc[r][q] += cv[r] * bv[q];
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        if (r >= R) continue;
        const int i = ty + 16 * r;
#pragma unroll
        for (int q = 0; q < RT; ++q) {
          if (q >= R) continue;
          const int j = tx + 16 * q;
          // mask first: exp of a positive cum_i - cum_j is never taken
          s_s[i * TP + j] = (j <= i && i < chunk) ? acc[r][q] * expf(cum_s[i] - cum_s[j]) : 0.f;
        }
      }
    }
    __syncthreads();

    // d(dtx) = S^T dy + w (.) (B dh), rows j, columns p; dx = d(dtx) dt;
    // per row j: sum_p d(dtx) x (ddt) and w_j sum_p dtx (B dh) (the w term)
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      if (r >= R) continue;
      const int j = ty + 16 * r;
      float acc[CP] = {}, bdh[CP] = {};
      for (int i = 0; i < chunk; ++i) {
        const float sv = s_s[i * TP + j];
#pragma unroll
        for (int q = 0; q < CP; ++q) acc[q] += sv * dy_s[i * P + tx + 16 * q];
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        const float bv = b_s[j * NP + n];
#pragma unroll
        for (int q = 0; q < CP; ++q) bdh[q] += bv * dh_s[n * PP + tx + 16 * q];
      }
      float xd = 0.f, dw = 0.f;
      if (j < chunk) {
        const size_t row = (static_cast<size_t>(b) * L + l0 + j) * H + h;
        const float d = dt[row];
#pragma unroll
        for (int q = 0; q < CP; ++q) {
          const int p = tx + 16 * q;
          const float g = acc[q] + w_s[j] * bdh[q];
          dx[row * P + p] = g * d;
          xd += g * x[row * P + p];
          dw += dtx_s[j * PP + p] * bdh[q];
        }
      }
      xd = row_sum(xd);
      dw = row_sum(dw);
      if (tx == 0) {
        xd_s[j] = xd;
        wdw_s[j] = w_s[j] * dw;
      }
    }
    __syncthreads();   // every read of S is done

    // dS = dy dtx^T on the causal part: dG = dS exp(cum_i - cum_j) replaces
    // S; dS (.) S gives dcum_i its row sums and dcum_j its column sums
    {
      float acc[RT][RT] = {};
#pragma unroll 4
      for (int p = 0; p < P; ++p) {
        float gv[RT], xv[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          gv[r] = r < R ? dy_s[(ty + 16 * r) * P + p] : 0.f;
          xv[r] = r < R ? dtx_s[(tx + 16 * r) * PP + p] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int q = 0; q < RT; ++q) acc[r][q] += gv[r] * xv[q];
      }
      float cs[RT] = {};
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        if (r >= R) continue;
        const int i = ty + 16 * r;
        float rs = 0.f;
#pragma unroll
        for (int q = 0; q < RT; ++q) {
          if (q >= R) continue;
          const int j = tx + 16 * q;
          float dg = 0.f;
          if (j <= i && i < chunk) {
            const float qv = acc[r][q] * s_s[i * TP + j];
            dg = acc[r][q] * expf(cum_s[i] - cum_s[j]);
            rs += qv;
            cs[q] += qv;
          }
          s_s[i * TP + j] = dg;
        }
        rs = row_sum(rs);
        if (tx == 0) dcum_s[i] = rs;
      }
#pragma unroll
      for (int q = 0; q < RT; ++q)
        if (q < R) colq_s[ty * Tp + tx + 16 * q] = cs[q];
    }
    __syncthreads();

    // dC (this head's part) = dG B + exp(cum) (dy h^T), rows i, columns n;
    // the C h term of dcum_i is c_i . (exp(cum_i) dy_i h^T)
    const size_t part = bh * L + l0;   // row l0 of this (b, h)'s partials
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      if (r >= R) continue;
      const int i = ty + 16 * r;
      float intra[CN] = {}, inter[CN] = {};
      for (int j = 0; j <= i && j < chunk; ++j) {
        const float g = s_s[i * TP + j];
#pragma unroll
        for (int q = 0; q < CN; ++q) intra[q] += g * b_s[j * NP + tx + 16 * q];
      }
#pragma unroll 4
      for (int p = 0; p < P; ++p) {
        const float g = dy_s[i * P + p];
#pragma unroll
        for (int q = 0; q < CN; ++q) inter[q] += g * hp[(tx + 16 * q) * P + p];
      }
      float yi = 0.f;
#pragma unroll
      for (int q = 0; q < CN; ++q) {
        inter[q] *= ecum_s[i];
        yi += c_s[i * NP + tx + 16 * q] * inter[q];
        if (i < chunk) dcp[(part + i) * N + tx + 16 * q] = intra[q] + inter[q];
      }
      yi = row_sum(yi);
      if (tx == 0) yi_s[i] = yi;
    }

    // dB (this head's part) = dG^T C + w (.) (dtx dh^T), rows j, columns n
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      if (r >= R) continue;
      const int j = ty + 16 * r;
      float intra[CN] = {}, inter[CN] = {};
      for (int i = j; i < chunk; ++i) {
        const float g = s_s[i * TP + j];
#pragma unroll
        for (int q = 0; q < CN; ++q) intra[q] += g * c_s[i * NP + tx + 16 * q];
      }
#pragma unroll 4
      for (int p = 0; p < P; ++p) {
        const float g = dtx_s[j * PP + p];
#pragma unroll
        for (int q = 0; q < CN; ++q) inter[q] += g * dh_s[(tx + 16 * q) * PP + p];
      }
      if (j < chunk) {
#pragma unroll
        for (int q = 0; q < CN; ++q)
          dbp[(part + j) * N + tx + 16 * q] = intra[q] + w_s[j] * inter[q];
      }
    }

    // the new dh = decay dh + C^T (exp(cum) (.) dy); the decay term of
    // dcum_last is decay sum(dh (.) h)
    {
      float acc[RN][CP] = {};
      for (int i = 0; i < chunk; ++i) {
        float gv[CP];
#pragma unroll
        for (int q = 0; q < CP; ++q) gv[q] = ecum_s[i] * dy_s[i * P + tx + 16 * q];
#pragma unroll
        for (int r = 0; r < RN; ++r) {
          const float cv = c_s[i * NP + ty + 16 * r];
#pragma unroll
          for (int q = 0; q < CP; ++q) acc[r][q] += cv * gv[q];
        }
      }
      float dec = 0.f;
#pragma unroll
      for (int r = 0; r < RN; ++r)
#pragma unroll
        for (int q = 0; q < CP; ++q) {
          const int n = ty + 16 * r, p = tx + 16 * q;
          const float g = dh_s[n * PP + p];
          dec += g * hp[n * P + p];
          acc[r][q] += decay * g;
        }
      dec = rt::warp_sum(dec);
      if (lane == 0) red_s[tid >> 5] = dec;
      __syncthreads();   // every read of dh is done
#pragma unroll
      for (int r = 0; r < RN; ++r)
#pragma unroll
        for (int q = 0; q < CP; ++q) dh_s[(ty + 16 * r) * PP + tx + 16 * q] = acc[r][q];
    }
    __syncthreads();

    // dcum, then d(ldec) as its reverse cumsum (one warp, 4 rows a lane);
    // ddt = sum_p d(dtx) x + a d(ldec); dA's part d(ldec) dt
    if (tid < 32) {
      float v[4], wsum = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = lane * 4 + e;
        v[e] = 0.f;
        if (r < chunk) {
          float cs = 0.f;
          for (int y = 0; y < 16; ++y) cs += colq_s[y * Tp + r];
          v[e] = dcum_s[r] - cs + yi_s[r] - wdw_s[r];
          wsum += wdw_s[r];
        }
      }
      wsum = rt::warp_sum(wsum);
      float dec = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) dec += red_s[w];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (lane * 4 + e == chunk - 1) v[e] += wsum + decay * dec;
      // reverse inclusive cumsum: within the lane, then over the lanes after it
      float run = 0.f;
#pragma unroll
      for (int e = 3; e >= 0; --e) {
        run += v[e];
        v[e] = run;
      }
      float post = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_down_sync(0xffffffffu, post, off);
        if (lane + off < 32) post += o;
      }
      post -= run;   // the sum of the lanes after this one
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = lane * 4 + e;
        if (r < chunk) {
          const size_t row = (static_cast<size_t>(b) * L + l0 + r) * H + h;
          const float dl = v[e] + post;
          ddt[row] = xd_s[r] + ah * dl;
          da_lane += dl * dt[row];
        }
      }
    }
    __syncthreads();   // the next chunk's staging overwrites what was read
  }

  if (tid < 32) {
    const float da = rt::warp_sum(da_lane);
    if (lane == 0) dap[bh] = da;
  }
  if (dh0 != nullptr)
    for (int i = tid; i < N * P; i += kThreads) dh0[st + i] = dh_s[(i / P) * PP + i % P];
}

// db[b, l, n] = sum_h dbp[b, h, l, n] (dc alike), heads in order; da[h] =
// sum_b dap[b, h], rows in order.  No atomics: the same bits every run.
__global__ void ssd_bwd_reduce(const float* __restrict__ dbp, const float* __restrict__ dcp,
                               const float* __restrict__ dap, float* __restrict__ db,
                               float* __restrict__ dc, float* __restrict__ da, int B, int L,
                               int H, int N) {
  const long long LN = static_cast<long long>(L) * N;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < B * LN) {
    const long long bb = i / LN, rem = i % LN;
    float sb = 0.f, sc = 0.f;
    for (int h = 0; h < H; ++h) {
      const long long at = (bb * H + h) * LN + rem;
      sb += dbp[at];
      sc += dcp[at];
    }
    db[i] = sb;
    dc[i] = sc;
  }
  if (blockIdx.x == 0)
    for (int h = threadIdx.x; h < H; h += blockDim.x) {
      float s = 0.f;
      for (int bb = 0; bb < B; ++bb) s += dap[bb * H + h];
      da[h] = s;
    }
}

template <int N, int P>
cudaError_t launch_t(const float* x, const float* dt, const float* a, const float* b,
                     const float* c, const float* h0, const float* dy, const float* dh_final,
                     float* hs, float* dbp, float* dcp, float* dap, float* dx, float* ddt,
                     float* db, float* dc, float* da, float* dh0, int B, int L, int H, int chunk,
                     cudaStream_t stream) {
  auto kernel = ssd_bwd_kernel<N, P>;
  static const cudaError_t attr =   // once per process: the largest chunk's need
      rt::set_smem(kernel, smem_floats<N, P>(kMaxT) * sizeof(float));
  if (attr != cudaSuccess) return attr;
  const size_t smem = smem_floats<N, P>((chunk + 15) / 16 * 16) * sizeof(float);
  kernel<<<dim3(H, B), kThreads, smem, stream>>>(x, dt, a, b, c, h0, dy, dh_final, hs, dx, ddt,
                                                 dbp, dcp, dap, dh0, L, H, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = static_cast<long long>(B) * L * N;
  ssd_bwd_reduce<<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(
      dbp, dcp, dap, db, dc, da, B, L, H, N);
  return cudaGetLastError();
}

cudaError_t dispatch(int N, int P, const float* x, const float* dt, const float* a,
                     const float* b, const float* c, const float* h0, const float* dy,
                     const float* dh_final, float* hs, float* dbp, float* dcp, float* dap,
                     float* dx, float* ddt, float* db, float* dc, float* da, float* dh0, int B,
                     int L, int H, int chunk, cudaStream_t s) {
#define SSD_BWD_CASE(NN, PP)                                                                   \
  if (N == NN && P == PP)                                                                      \
    return launch_t<NN, PP>(x, dt, a, b, c, h0, dy, dh_final, hs, dbp, dcp, dap, dx, ddt, db,  \
                            dc, da, dh0, B, L, H, chunk, s);
  SSD_BWD_CASE(16, 32) SSD_BWD_CASE(16, 64) SSD_BWD_CASE(32, 32) SSD_BWD_CASE(32, 64)
  SSD_BWD_CASE(64, 32) SSD_BWD_CASE(64, 64)
#undef SSD_BWD_CASE
  return cudaErrorInvalidValue;
}

}  // namespace bwd

// ============================================= backward, bf16: tensor cores ====
namespace bwdtc {

using bf16 = __nv_bfloat16;
using tc::split_bf16;

constexpr int kWarps = 4, kThreads = 32 * kWarps;
constexpr int kRows = 128;       // rows of the largest chunk
constexpr int kMaxHeads = 8;     // heads per block (mamba_scan.py MAX_BWD_HEADS)
constexpr int kSlots = 9;        // G^T tiles of a warp's two row blocks
constexpr float kLog2e = 1.4426950408889634f;

// Element offset of 16-byte chunk c of row r in a swizzled tile of R16
// chunks a row (the forward's layout; rows of 16 or more chunks XOR the
// low three bits of c with the row, so 8 rows at one chunk hit 8 groups).
template <int R16>
__device__ __forceinline__ int swz(int r, int c) {
  if constexpr (R16 >= 8) return (r * R16 + (c ^ (r & 7))) * 8;
  else return tc::swz<R16>(r, c);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Rows [0, Tp) of a tile of R16 16-byte chunks a row from src (row stride
// `stride` elements), swizzled into dst; rows past T are zero.
template <int R16>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, size_t stride, int T,
                                          int Tp) {
  for (int i = threadIdx.x; i < Tp * R16; i += kThreads) {
    const int r = i / R16, c = i % R16;
    const bool ok = r < T;
    mma::cp_async16(dst + swz<R16>(r, c), ok ? src + r * stride + c * 8 : src, ok);
  }
}

// dt of one head over the chunk (src = dt at its first row; stride H).
__device__ __forceinline__ void load_dt(float* dst, const float* src, int H, int T, int Tp) {
  for (int r = threadIdx.x; r < Tp; r += kThreads) {
    const bool ok = r < T;
    mma::cp_async4(dst + r, ok ? src + static_cast<size_t>(r) * H : src, ok);
  }
}

// One head's state h_k or dh_k as ssd_bwd_pass stores it (per state row n
// and 8 columns: 8 bf16 high parts, then 8 low parts) into a high plane
// and a low plane [N][P] at dst, dst + N P, swizzled.
template <int N, int P>
__device__ __forceinline__ void load_state(bf16* dst, const float* src) {
  constexpr int RP = P / 8;
  const bf16* s = reinterpret_cast<const bf16*>(src);
  for (int i = threadIdx.x; i < N * RP * 2; i += kThreads) {
    const int part = i & 1, g8 = i >> 1;
    mma::cp_async16(dst + part * N * P + swz<RP>(g8 / RP, g8 % RP), s + g8 * 16 + part * 8, true);
  }
}

// Warp: the inclusive cumsum of ldec = ah dt over the chunk (rows past T
// hold dt 0), as the forward forms it; writes exp(cum) and w =
// exp(cum_{T-1} - cum) (both 0 past T) and, when cum2 is set, cum in log2
// units; returns decay = exp(cum_{T-1}) on every lane.
__device__ __forceinline__ float chunk_cumsum(const float* dt_s, float ah, int T, int Tp,
                                              float* cum2, float* ecum, float* w) {
  const int lane = threadIdx.x & 31;
  float v[4], run = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = lane * 4 + k;
    run += r < Tp ? ah * dt_s[r] : 0.f;
    v[k] = run;
  }
  float pre = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, pre, off);
    if (lane >= off) pre += o;
  }
  pre -= run;
  const int kl = (T - 1) & 3;
  const float mine = kl == 0 ? v[0] : kl == 1 ? v[1] : kl == 2 ? v[2] : v[3];
  const float last = __shfl_sync(0xffffffffu, mine + pre, (T - 1) >> 2);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = lane * 4 + k;
    if (r < Tp) {
      const float cum = v[k] + pre;
      if (cum2 != nullptr) cum2[r] = cum * kLog2e;
      ecum[r] = r < T ? expf(cum) : 0.f;
      w[r] = r < T ? expf(last - cum) : 0.f;
    }
  }
  return expf(last);
}

// ---- (a) the chunk-local states ----------------------------------------------
struct StatesSmem {
  size_t c, b, x, dy, dt, ecum, w, total;
  __host__ __device__ StatesSmem(int N, int P) {
    c = 0;
    b = c + static_cast<size_t>(kRows) * N * sizeof(bf16);
    x = b + static_cast<size_t>(kRows) * N * sizeof(bf16);
    dy = x + static_cast<size_t>(kRows) * P * sizeof(bf16);
    dt = dy + static_cast<size_t>(kRows) * P * sizeof(bf16);
    ecum = dt + kRows * sizeof(float);
    w = ecum + kRows * sizeof(float);
    total = w + kRows * sizeof(float);
  }
};

// acc (rows n = 16 i + .., columns 8 (4 warp + nt) + ..: this warp's
// quarter of P) = M^T (v (.) wv) over chunk rows [0, 16 nks), M [rows][N]
// (b or c) exact in bf16, v [rows][P] (dtx or dy) times the row weights
// wv as a bf16 high and a bf16 low part: two products.
template <int N, int P>
__device__ __forceinline__ void chunk_state(float (&acc)[N / 16][P / 32][4], const bf16* m_s,
                                            const bf16* v_s, const float* wv, int nks) {
  constexpr int MT = N / 16, NT = P / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, mi = lane >> 3, qd = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][nt][e] = 0.f;
  for (int ks = 0; ks < nks; ++ks) {
    const float2 w0 = *reinterpret_cast<const float2*>(wv + 16 * ks + 2 * qd);
    const float2 w1 = *reinterpret_cast<const float2*>(wv + 16 * ks + 8 + 2 * qd);
    uint32_t vh[NT][2], vl[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t vb[2];
      mma::ldsm_x2_t(vb, v_s + swz<P / 8>(16 * ks + (mi & 1) * 8 + (lane & 7), warp * NT + nt));
      const float2 d0 = mma::unpack_bf16(vb[0]), d1 = mma::unpack_bf16(vb[1]);
      uint32_t p0[2], p1[2];
      split_bf16(p0, d0.x * w0.x, d0.y * w0.y);
      split_bf16(p1, d1.x * w1.x, d1.y * w1.y);
      vh[nt][0] = p0[0];
      vl[nt][0] = p0[1];
      vh[nt][1] = p1[0];
      vl[nt][1] = p1[1];
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      uint32_t ma[4];   // M^T rows 16 i .., k = chunk rows 16 ks ..
      mma::ldsm_x4_t(ma, m_s + swz<N / 8>(16 * ks + (mi >> 1) * 8 + (lane & 7), 2 * i + (mi & 1)));
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mma::mma_bf16(acc[i][nt], ma, vh[nt][0], vh[nt][1]);
        mma::mma_bf16(acc[i][nt], ma, vl[nt][0], vl[nt][1]);
      }
    }
  }
}

template <int N, int P>
__device__ __forceinline__ void store_state(float* dst, const float (&acc)[N / 16][P / 32][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, qd = lane & 3;
#pragma unroll
  for (int i = 0; i < N / 16; ++i)
#pragma unroll
    for (int nt = 0; nt < P / 32; ++nt) {
      const int n = 16 * i + gq, p = 8 * (warp * (P / 32) + nt) + 2 * qd;
      *reinterpret_cast<float2*>(dst + n * P + p) = make_float2(acc[i][nt][0], acc[i][nt][1]);
      *reinterpret_cast<float2*>(dst + (n + 8) * P + p) = make_float2(acc[i][nt][2], acc[i][nt][3]);
    }
}

// Block (chunk blockIdx.x, head group blockIdx.y, batch row blockIdx.z):
// per head, s = B^T (w (.) dtx) into st and u = C^T (exp(cum) (.) dy) into
// ust ([B, L/T, H, N, P] f32), decay = exp(cum_{T-1}) into dec.
template <int N, int P>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_states(const bf16* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
              const bf16* __restrict__ bm, const bf16* __restrict__ cm,
              const bf16* __restrict__ dy, float* __restrict__ st, float* __restrict__ ust,
              float* __restrict__ dec, int L, int H, int chunk, int hg) {
  constexpr int RP = P / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const StatesSmem lay(N, P);
  bf16* c_s = reinterpret_cast<bf16*>(smem + lay.c);
  bf16* b_s = reinterpret_cast<bf16*>(smem + lay.b);
  bf16* x_s = reinterpret_cast<bf16*>(smem + lay.x);
  bf16* dy_s = reinterpret_cast<bf16*>(smem + lay.dy);
  float* dt_s = reinterpret_cast<float*>(smem + lay.dt);
  float* ecum_s = reinterpret_cast<float*>(smem + lay.ecum);
  float* w_s = reinterpret_cast<float*>(smem + lay.w);

  const int k = blockIdx.x, b = blockIdx.z, hf = blockIdx.y * hg, nc = L / chunk;
  const int nh = min(hg, H - hf);
  const int T = chunk, Tp = (T + 15) / 16 * 16;
  const size_t row0 = static_cast<size_t>(b) * L + static_cast<size_t>(k) * T;

  load_tile<N / 8>(c_s, cm + row0 * N, N, T, Tp);
  load_tile<N / 8>(b_s, bm + row0 * N, N, T, Tp);
  for (int hh = 0; hh < nh; ++hh) {
    const int hd = hf + hh;
    load_tile<RP>(x_s, x + (row0 * H + hd) * P, static_cast<size_t>(H) * P, T, Tp);
    load_tile<RP>(dy_s, dy + (row0 * H + hd) * P, static_cast<size_t>(H) * P, T, Tp);
    load_dt(dt_s, dt + row0 * H + hd, H, T, Tp);
    mma::cp_async_commit();
    mma::cp_async_wait<0>();
    __syncthreads();
    const size_t slot = (static_cast<size_t>(b) * nc + k) * H + hd;
    if (threadIdx.x < 32) {
      const float d = chunk_cumsum(dt_s, a[hd], T, Tp, nullptr, ecum_s, w_s);
      if (threadIdx.x == 0) dec[slot] = d;
    }
    // dtx = round(dt x) in place, as the forward forms it
    for (int i = threadIdx.x; i < Tp * RP; i += kThreads) {
      const int r = i / RP, c = i % RP;
      uint4* at = reinterpret_cast<uint4*>(x_s + swz<RP>(r, c));
      uint4 u = *at;
      const float d = dt_s[r];
      uint32_t* wd = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = mma::unpack_bf16(wd[e]);
        wd[e] = mma::pack_bf16(d * f.x, d * f.y);
      }
      *at = u;
    }
    __syncthreads();
    float acc[N / 16][P / 32][4];
    chunk_state<N, P>(acc, b_s, x_s, w_s, Tp / 16);
    store_state<N, P>(st + slot * N * P, acc);
    chunk_state<N, P>(acc, c_s, dy_s, ecum_s, Tp / 16);
    store_state<N, P>(ust + slot * N * P, acc);
    __syncthreads();   // x, dy, dt are free for the next head
  }
}

// ---- (b) state passing ----------------------------------------------------------
// 8 f32 values as 8 bf16 high parts then their 8 bf16 remainders (32 bytes).
__device__ __forceinline__ void store_split(float* p, const float (&v)[8]) {
  uint32_t hi[4], lo[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t hl[2];
    split_bf16(hl, v[2 * i], v[2 * i + 1]);
    hi[i] = hl[0];
    lo[i] = hl[1];
  }
  reinterpret_cast<uint4*>(p)[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  reinterpret_cast<uint4*>(p)[1] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
}

// One recurrence v <- dec_k v + in_k over the chunks (forward: k = 0 ..,
// else from the last), storing v before each step over in_k (split).
__device__ __forceinline__ void pass(float (&v)[8], float* buf, const float* dec, int b, int h,
                                     int nc, int H, int NP, int e, bool forward) {
  auto at = [&](int k) {
    return (static_cast<size_t>(b) * nc + k) * H + h;
  };
  int k = forward ? 0 : nc - 1;
  const int step = forward ? 1 : -1;
  float4 n0 = reinterpret_cast<const float4*>(buf + at(k) * NP + e)[0];
  float4 n1 = reinterpret_cast<const float4*>(buf + at(k) * NP + e)[1];
  for (int i = 0; i < nc; ++i, k += step) {
    const float4 s0 = n0, s1 = n1;
    if (i + 1 < nc) {   // the next chunk's input, ahead of this one's store
      n0 = reinterpret_cast<const float4*>(buf + at(k + step) * NP + e)[0];
      n1 = reinterpret_cast<const float4*>(buf + at(k + step) * NP + e)[1];
    }
    store_split(buf + at(k) * NP + e, v);
    const float d = dec[at(k)];
    const float in[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = d * v[j] + in[j];
  }
}

// Thread: (batch row, head, 8 consecutive entries of the [N, P] state).
// The forward recurrence from h0 (or 0) writes h_k over s_k; the reverse
// from dh_final (or 0) writes dh_k (the gradient of the state after chunk
// k) over u_k and leaves dh0.
__global__ void __launch_bounds__(256)
ssd_bwd_pass(float* __restrict__ st, float* __restrict__ ust, const float* __restrict__ dec,
            const float* __restrict__ h0, const float* __restrict__ dh_final,
            float* __restrict__ dh0, int B, int H, int nc, int NP) {
  const long long g = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  const int per = NP / 8;
  if (g >= static_cast<long long>(B) * H * per) return;
  const long long bh = g / per;
  const int e = static_cast<int>(g % per) * 8;
  const int b = static_cast<int>(bh / H), h = static_cast<int>(bh % H);
  float v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = h0 != nullptr ? h0[bh * NP + e + j] : 0.f;
  pass(v, st, dec, b, h, nc, H, NP, e, true);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = dh_final != nullptr ? dh_final[bh * NP + e + j] : 0.f;
  pass(v, ust, dec, b, h, nc, H, NP, e, false);
  if (dh0 != nullptr)
#pragma unroll
    for (int j = 0; j < 8; ++j) dh0[bh * NP + e + j] = v[j];
}

// ---- (c) the chunk-local gradients -------------------------------------------
// Shared memory of a block with hg heads (offsets in bytes).  Region R is
// reused: loop 1 holds G^T (thread-private f32 fragments), dy and dh;
// between the loops the summed dG^T (high and low planes [kRows][kRows]);
// loop 2 h (over G^T), dy and dh.
struct ChunkSmem {
  size_t c, b, gt, h, dg, dy, dh, dt, cum2, ecum, w, rq, dcum, wsum, red, total;
  __host__ __device__ ChunkSmem(int N, int P, int hg) {
    c = 0;
    b = c + static_cast<size_t>(kRows) * N * sizeof(bf16);
    const size_t r = b + static_cast<size_t>(kRows) * N * sizeof(bf16);
    gt = r;
    h = r;
    dg = r;
    const size_t gt_bytes = static_cast<size_t>(kWarps) * kSlots * 32 * 8 * sizeof(float);
    const size_t st_bytes = 2 * static_cast<size_t>(N) * P * sizeof(bf16);
    dy = r + (gt_bytes > st_bytes ? gt_bytes : st_bytes);
    dh = dy + static_cast<size_t>(kRows) * P * sizeof(bf16);
    const size_t e1 = dh + st_bytes, e2 = dg + 2 * static_cast<size_t>(kRows) * kRows * sizeof(bf16);
    dt = e1 > e2 ? e1 : e2;
    cum2 = dt + kRows * sizeof(float);
    ecum = cum2 + kRows * sizeof(float);
    w = ecum + kRows * sizeof(float);
    rq = w + kRows * sizeof(float);                                  // [8][kRows]
    dcum = rq + 8 * kRows * sizeof(float);                           // [hg][kRows]
    wsum = dcum + static_cast<size_t>(hg) * kRows * sizeof(float);   // [hg][kWarps]
    red = wsum + static_cast<size_t>(hg) * kWarps * sizeof(float);   // [kWarps + 1]
    total = red + 8 * sizeof(float);
  }
};

// What the row-block steps of a chunk-gradient block share.
struct Ctx {
  const bf16* x;
  bf16* dx;
  float* ddt;
  const bf16 *c_s, *b_s, *dy_s, *dh_s, *h_s;
  bf16* dg_s;
  const float *gt_s, *dt_s, *cum2_s, *ecum_s, *w_s;
  float *rq_s, *dcum_s;
  size_t row0;   // the chunk's first row of [B L]
  int H, T, nrb, warp, lane, mi, gq, qd;
};

// x's A fragments of rows j0 = 16 J + gq, j1 = j0 + 8 of head hd (zero
// past T), read from device memory, as dtx = round(dt x) (the A layout is
// also the D layout of a product's rows j0, j1).
template <int P>
__device__ __forceinline__ void dtx_frags(uint32_t (&da)[P / 16][4], const Ctx& cx, int J,
                                          int hd) {
  const int j0 = 16 * J + cx.gq, j1 = j0 + 8;
  const bool v0 = j0 < cx.T, v1 = j1 < cx.T;
  const float d0 = cx.dt_s[j0], d1 = cx.dt_s[j1];
  const bf16* x0 = cx.x + ((cx.row0 + j0) * cx.H + hd) * P + 2 * cx.qd;
  const bf16* x1 = cx.x + ((cx.row0 + j1) * cx.H + hd) * P + 2 * cx.qd;
#pragma unroll
  for (int kk = 0; kk < P / 16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = (e & 1) ? v1 : v0;
      const bf16* at = ((e & 1) ? x1 : x0) + 16 * kk + (e >> 1) * 8;
      const float d = (e & 1) ? d1 : d0;
      const float2 f = mma::unpack_bf16(ok ? __ldg(reinterpret_cast<const unsigned int*>(at)) : 0u);
      da[kk][e] = mma::pack_bf16(d * f.x, d * f.y);
    }
  }
}

// The slot of column tile I = J + t of row block R (J = R ? 7 - warp :
// warp) in a warp's nine G^T / dG^T tiles: row block warp takes slots 0
// .. 7 - warp, row block 7 - warp slots 8 down to 8 - warp, so both index
// one register array statically.
template <int R>
__device__ __forceinline__ constexpr int tile_slot(int t) { return R ? 8 - t : t; }

// Loop 1, row block J = (R ? 7 - warp : warp) of head hd (slot hh): d(dtx)
// = S^T dy + w (.) (B dh) -> dx and the x term of ddt; dS^T = dtx dy^T ->
// dG^T summed into dg (two n8 tiles a slot); the row sums of dS (.) S
// over i (the column sums of dS (.) S at j, into dcum) and this row
// block's part of the column sums (into rq); the w term.
template <int N, int P, int R>
__device__ __forceinline__ void loop1_rows(float (&dg)[2 * kSlots][4], const Ctx& cx, int hh,
                                           int hd, float& wpart) {
  constexpr int RN = N / 8, RP = P / 8, KN = N / 16, KP = P / 16;
  constexpr int kTiles = R ? 4 : 8;   // column tiles I >= J at most
  const int warp = cx.warp, lane = cx.lane, mi = cx.mi, gq = cx.gq, qd = cx.qd;
  const int J = R ? 7 - warp : warp;
  const int j0 = 16 * J + gq, j1 = j0 + 8;
  uint32_t da[KP][4];
  dtx_frags<P>(da, cx, J, hd);
  // B dh (dh as high + low parts), then the w term, then scaled by w
  float acc[2 * KP][4];
#pragma unroll
  for (int nt = 0; nt < 2 * KP; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KN; ++kk) {
    uint32_t ba[4];
    mma::ldsm_x4(ba, cx.b_s + swz<RN>(16 * J + (mi & 1) * 8 + (lane & 7), 2 * kk + (mi >> 1)));
#pragma unroll
    for (int cp = 0; cp < KP; ++cp) {
      uint32_t hb[4], lb[4];
      const int off = swz<RP>(16 * kk + (mi & 1) * 8 + (lane & 7), 2 * cp + (mi >> 1));
      mma::ldsm_x4_t(hb, cx.dh_s + off);
      mma::ldsm_x4_t(lb, cx.dh_s + N * P + off);
      mma::mma_bf16(acc[2 * cp], ba, hb[0], hb[1]);
      mma::mma_bf16(acc[2 * cp], ba, lb[0], lb[1]);
      mma::mma_bf16(acc[2 * cp + 1], ba, hb[2], hb[3]);
      mma::mma_bf16(acc[2 * cp + 1], ba, lb[2], lb[3]);
    }
  }
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < 2 * KP; ++nt) {
    const float2 t0 = mma::unpack_bf16(da[nt >> 1][(nt & 1) * 2]);
    const float2 t1 = mma::unpack_bf16(da[nt >> 1][(nt & 1) * 2 + 1]);
    s0 += t0.x * acc[nt][0] + t0.y * acc[nt][1];
    s1 += t1.x * acc[nt][2] + t1.y * acc[nt][3];
  }
  const float w0 = cx.w_s[j0], w1 = cx.w_s[j1];
  const float wdw0 = w0 * quad_sum(s0), wdw1 = w1 * quad_sum(s1);
#pragma unroll
  for (int nt = 0; nt < 2 * KP; ++nt) {
    acc[nt][0] *= w0;
    acc[nt][1] *= w0;
    acc[nt][2] *= w1;
    acc[nt][3] *= w1;
  }
  // tiles I >= J: dS^T = dtx dy^T, S^T = G^T (.) exp(cum_i - cum_j)
  float cq0 = 0.f, cq1 = 0.f;
  const float cj0 = cx.cum2_s[j0], cj1 = cx.cum2_s[j1];
#pragma unroll
  for (int t = 0; t < kTiles; ++t) {
    const int I = J + t, sl_t = tile_slot<R>(t);
    if (I >= cx.nrb) break;
    float ds[2][4];
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[half][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KP; ++kk) {
      uint32_t yb[4];
      mma::ldsm_x4(yb, cx.dy_s + swz<RP>(16 * I + (mi >> 1) * 8 + (lane & 7), 2 * kk + (mi & 1)));
      mma::mma_bf16(ds[0], da[kk], yb[0], yb[1]);
      mma::mma_bf16(ds[1], da[kk], yb[2], yb[3]);
    }
    const float4* slot =
        reinterpret_cast<const float4*>(cx.gt_s) + (warp * kSlots + sl_t) * 64 + lane;
    const float4 ga = slot[0], gb = slot[32];
    float gv[2][4];
    gv[0][0] = ga.x; gv[0][1] = ga.y; gv[0][2] = ga.z; gv[0][3] = ga.w;
    gv[1][0] = gb.x; gv[1][1] = gb.y; gv[1][2] = gb.z; gv[1][3] = gb.w;
    uint32_t sa[4], sl[4];   // S^T as the A operand, high and low parts
    float colp[2][2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = 16 * I + 8 * half + 2 * qd;
      const float2 ci = *reinterpret_cast<const float2*>(cx.cum2_s + i);
      float sv[4], qv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jj = e < 2 ? j0 : j1, ii = i + (e & 1);
        const float cii = (e & 1) ? ci.y : ci.x, cjj = e < 2 ? cj0 : cj1;
        // mask first: exp of a positive cum_i - cum_j is never taken
        const float ex = (ii >= jj && ii < cx.T) ? exp2f(cii - cjj) : 0.f;
        sv[e] = gv[half][e] * ex;
        qv[e] = ds[half][e] * sv[e];
        dg[2 * sl_t + half][e] += ds[half][e] * ex;
      }
      cq0 += qv[0] + qv[1];
      cq1 += qv[2] + qv[3];
      colp[half][0] = qv[0] + qv[2];
      colp[half][1] = qv[1] + qv[3];
      uint32_t p0[2], p1[2];
      split_bf16(p0, sv[0], sv[1]);
      split_bf16(p1, sv[2], sv[3]);
      sa[2 * half] = p0[0];
      sl[2 * half] = p0[1];
      sa[2 * half + 1] = p1[0];
      sl[2 * half + 1] = p1[1];
    }
    // this row block's part of the column sums (over j) of dS (.) S
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float v = colp[half][c];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (gq == 0) cx.rq_s[J * kRows + 16 * I + 8 * half + 2 * qd + c] = v;
      }
    // d(dtx) += S^T dy (dy rows I as the k dimension)
#pragma unroll
    for (int cp = 0; cp < KP; ++cp) {
      uint32_t yb[4];
      mma::ldsm_x4_t(yb, cx.dy_s + swz<RP>(16 * I + (mi & 1) * 8 + (lane & 7), 2 * cp + (mi >> 1)));
      mma::mma_bf16(acc[2 * cp], sa, yb[0], yb[1]);
      mma::mma_bf16(acc[2 * cp + 1], sa, yb[2], yb[3]);
      mma::mma_bf16(acc[2 * cp], sl, yb[0], yb[1]);
      mma::mma_bf16(acc[2 * cp + 1], sl, yb[2], yb[3]);
    }
  }
  cq0 = quad_sum(cq0);
  cq1 = quad_sum(cq1);
  // dx = d(dtx) dt; the x term of ddt, sum_p d(dtx) x
  const bool v0 = j0 < cx.T, v1 = j1 < cx.T;
  const float d0 = cx.dt_s[j0], d1 = cx.dt_s[j1];
  bf16* dx0 = cx.dx + ((cx.row0 + j0) * cx.H + hd) * P + 2 * qd;
  bf16* dx1 = cx.dx + ((cx.row0 + j1) * cx.H + hd) * P + 2 * qd;
  float xd0 = 0.f, xd1 = 0.f;
  const bf16* x0 = cx.x + ((cx.row0 + j0) * cx.H + hd) * P + 2 * qd;
  const bf16* x1 = cx.x + ((cx.row0 + j1) * cx.H + hd) * P + 2 * qd;
#pragma unroll
  for (int nt = 0; nt < 2 * KP; ++nt) {
    const float2 t0 =
        mma::unpack_bf16(v0 ? __ldg(reinterpret_cast<const unsigned int*>(x0 + 8 * nt)) : 0u);
    const float2 t1 =
        mma::unpack_bf16(v1 ? __ldg(reinterpret_cast<const unsigned int*>(x1 + 8 * nt)) : 0u);
    xd0 += acc[nt][0] * t0.x + acc[nt][1] * t0.y;
    xd1 += acc[nt][2] * t1.x + acc[nt][3] * t1.y;
    if (v0)
      *reinterpret_cast<__nv_bfloat162*>(dx0 + 8 * nt) =
          __floats2bfloat162_rn(acc[nt][0] * d0, acc[nt][1] * d0);
    if (v1)
      *reinterpret_cast<__nv_bfloat162*>(dx1 + 8 * nt) =
          __floats2bfloat162_rn(acc[nt][2] * d1, acc[nt][3] * d1);
  }
  xd0 = quad_sum(xd0);
  xd1 = quad_sum(xd1);
  if (qd == 0) {
    if (v0) cx.ddt[(cx.row0 + j0) * cx.H + hd] = xd0;   // loop 2 adds a d(ldec)
    if (v1) cx.ddt[(cx.row0 + j1) * cx.H + hd] = xd1;
    cx.dcum_s[hh * kRows + j0] = -cq0 - wdw0;
    cx.dcum_s[hh * kRows + j1] = -cq1 - wdw1;
    wpart += wdw0 + wdw1;
  }
}

// Slot s of dg (n8 tiles 2 s, 2 s + 1) as A fragments, high and low.
__device__ __forceinline__ void dg_frags(uint32_t (&ah)[4], uint32_t (&al)[4],
                                         const float (&dg)[2 * kSlots][4], int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint32_t p0[2], p1[2];
    split_bf16(p0, dg[2 * t + half][0], dg[2 * t + half][1]);
    split_bf16(p1, dg[2 * t + half][2], dg[2 * t + half][3]);
    ah[2 * half] = p0[0];
    al[2 * half] = p0[1];
    ah[2 * half + 1] = p1[0];
    al[2 * half + 1] = p1[1];
  }
}

// dg (row block J's tiles I >= J) into the dG^T planes [j][i], high and low.
template <int R>
__device__ __forceinline__ void store_dg(const float (&dg)[2 * kSlots][4], const Ctx& cx) {
  const int J = R ? 7 - cx.warp : cx.warp, j0 = 16 * J + cx.gq;
#pragma unroll
  for (int t = 0; t < (R ? 4 : 8); ++t) {
    const int I = J + t;
    if (I >= cx.nrb) break;
    uint32_t ah[4], al[4];
    dg_frags(ah, al, dg, tile_slot<R>(t));
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int o0 = swz<kRows / 8>(j0, 2 * I + half) + 2 * cx.qd;
      const int o1 = swz<kRows / 8>(j0 + 8, 2 * I + half) + 2 * cx.qd;
      *reinterpret_cast<uint32_t*>(cx.dg_s + o0) = ah[2 * half];
      *reinterpret_cast<uint32_t*>(cx.dg_s + kRows * kRows + o0) = al[2 * half];
      *reinterpret_cast<uint32_t*>(cx.dg_s + o1) = ah[2 * half + 1];
      *reinterpret_cast<uint32_t*>(cx.dg_s + kRows * kRows + o1) = al[2 * half + 1];
    }
  }
}

// acc (rows J, N columns) += dG^T C over the tiles I >= J (dG^T from dg).
template <int N, int R>
__device__ __forceinline__ void db_intra(float (&acc)[N / 8][4], const float (&dg)[2 * kSlots][4],
                                         const Ctx& cx) {
  constexpr int RN = N / 8, KN = N / 16;
  const int J = R ? 7 - cx.warp : cx.warp, lane = cx.lane, mi = cx.mi;
#pragma unroll
  for (int t = 0; t < (R ? 4 : 8); ++t) {
    const int I = J + t;
    if (I >= cx.nrb) break;
    uint32_t ah[4], al[4];
    dg_frags(ah, al, dg, tile_slot<R>(t));
#pragma unroll
    for (int cn = 0; cn < KN; ++cn) {
      uint32_t cb[4];
      mma::ldsm_x4_t(cb, cx.c_s + swz<RN>(16 * I + (mi & 1) * 8 + (lane & 7), 2 * cn + (mi >> 1)));
      mma::mma_bf16(acc[2 * cn], ah, cb[0], cb[1]);
      mma::mma_bf16(acc[2 * cn + 1], ah, cb[2], cb[3]);
      mma::mma_bf16(acc[2 * cn], al, cb[0], cb[1]);
      mma::mma_bf16(acc[2 * cn + 1], al, cb[2], cb[3]);
    }
  }
}

// acc (rows I = r ? 7 - warp : warp, N columns) += dG B over the tiles
// J <= I, dG read transposed from the dG^T planes.
template <int N>
__device__ __forceinline__ void dc_intra(float (&acc)[N / 8][4], const Ctx& cx, int r) {
  constexpr int RN = N / 8, KN = N / 16;
  const int I = r ? 7 - cx.warp : cx.warp, lane = cx.lane, mi = cx.mi;
  for (int J = 0; J <= I; ++J) {
    uint32_t ah[4], al[4];
    const int off = swz<kRows / 8>(16 * J + (mi >> 1) * 8 + (lane & 7), 2 * I + (mi & 1));
    mma::ldsm_x4_t(ah, cx.dg_s + off);
    mma::ldsm_x4_t(al, cx.dg_s + kRows * kRows + off);
#pragma unroll
    for (int cn = 0; cn < KN; ++cn) {
      uint32_t bb[4];
      mma::ldsm_x4_t(bb, cx.b_s + swz<RN>(16 * J + (mi & 1) * 8 + (lane & 7), 2 * cn + (mi >> 1)));
      mma::mma_bf16(acc[2 * cn], ah, bb[0], bb[1]);
      mma::mma_bf16(acc[2 * cn + 1], ah, bb[2], bb[3]);
      mma::mma_bf16(acc[2 * cn], al, bb[0], bb[1]);
      mma::mma_bf16(acc[2 * cn + 1], al, bb[2], bb[3]);
    }
  }
}

// tmp (rows J, N columns) = A_J S^T for a state S [N][P] in high and low
// planes: A from registers (k = P), S^T read as the B operand.
template <int N, int P>
__device__ __forceinline__ void times_state_t(float (&tmp)[N / 8][4], const uint32_t (&af)[P / 16][4],
                                              const bf16* s_s, const Ctx& cx) {
  constexpr int RP = P / 8, KN = N / 16, KP = P / 16;
  const int lane = cx.lane, mi = cx.mi;
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) tmp[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KP; ++kk)
#pragma unroll
    for (int np = 0; np < KN; ++np) {
      uint32_t hb[4], lb[4];
      const int off = swz<RP>(16 * np + (mi >> 1) * 8 + (lane & 7), 2 * kk + (mi & 1));
      mma::ldsm_x4(hb, s_s + off);
      mma::ldsm_x4(lb, s_s + N * P + off);
      mma::mma_bf16(tmp[2 * np], af[kk], hb[0], hb[1]);
      mma::mma_bf16(tmp[2 * np], af[kk], lb[0], lb[1]);
      mma::mma_bf16(tmp[2 * np + 1], af[kk], hb[2], hb[3]);
      mma::mma_bf16(tmp[2 * np + 1], af[kk], lb[2], lb[3]);
    }
}

// Loop 2, row block J = (r ? 7 - warp : warp) of head hd (slot hh): db +=
// w (.) (dtx dh^T), dc += exp(cum) (.) (dy h^T), and the C h term of dcum,
// exp(cum_i) c_i . (dy h^T)_i.
template <int N, int P>
__device__ __forceinline__ void loop2_rows(float (&db)[N / 8][4], float (&dc)[N / 8][4],
                                           const Ctx& cx, int r, int hh, int hd) {
  constexpr int RN = N / 8, RP = P / 8, KP = P / 16;
  const int lane = cx.lane, mi = cx.mi, gq = cx.gq, qd = cx.qd;
  const int J = r ? 7 - cx.warp : cx.warp;
  const int j0 = 16 * J + gq, j1 = j0 + 8;
  float tmp[N / 8][4];
  {
    uint32_t da[KP][4];
    dtx_frags<P>(da, cx, J, hd);
    times_state_t<N, P>(tmp, da, cx.dh_s, cx);
  }
  const float w0 = cx.w_s[j0], w1 = cx.w_s[j1];
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt) {
    db[nt][0] += w0 * tmp[nt][0];
    db[nt][1] += w0 * tmp[nt][1];
    db[nt][2] += w1 * tmp[nt][2];
    db[nt][3] += w1 * tmp[nt][3];
  }
  {
    uint32_t ya[KP][4];
#pragma unroll
    for (int kk = 0; kk < KP; ++kk)
      mma::ldsm_x4(ya[kk], cx.dy_s + swz<RP>(16 * J + (mi & 1) * 8 + (lane & 7), 2 * kk + (mi >> 1)));
    times_state_t<N, P>(tmp, ya, cx.h_s, cx);
  }
  float y0 = 0.f, y1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt) {
    const float2 c0 =
        mma::unpack_bf16(*reinterpret_cast<const uint32_t*>(cx.c_s + swz<RN>(j0, nt) + 2 * qd));
    const float2 c1 =
        mma::unpack_bf16(*reinterpret_cast<const uint32_t*>(cx.c_s + swz<RN>(j1, nt) + 2 * qd));
    y0 += c0.x * tmp[nt][0] + c0.y * tmp[nt][1];
    y1 += c1.x * tmp[nt][2] + c1.y * tmp[nt][3];
  }
  const float e0 = cx.ecum_s[j0], e1 = cx.ecum_s[j1];
  y0 = quad_sum(y0);
  y1 = quad_sum(y1);
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt) {
    dc[nt][0] += e0 * tmp[nt][0];
    dc[nt][1] += e0 * tmp[nt][1];
    dc[nt][2] += e1 * tmp[nt][2];
    dc[nt][3] += e1 * tmp[nt][3];
  }
  if (qd == 0) {
    cx.dcum_s[hh * kRows + j0] += e0 * y0;
    cx.dcum_s[hh * kRows + j1] += e1 * y1;
  }
}

// This block's part (rows of row block r) of dB or dC: [B, G, L, N] f32,
// rows < T; base is the chunk's first row of this (batch row, group).
template <int N>
__device__ __forceinline__ void store_part(float* base, const float (&acc)[N / 8][4],
                                           const Ctx& cx, int r) {
  const int J = r ? 7 - cx.warp : cx.warp, j0 = 16 * J + cx.gq, j1 = j0 + 8;
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt) {
    const int n = 8 * nt + 2 * cx.qd;
    if (j0 < cx.T)
      *reinterpret_cast<float2*>(base + static_cast<size_t>(j0) * N + n) =
          make_float2(acc[nt][0], acc[nt][1]);
    if (j1 < cx.T)
      *reinterpret_cast<float2*>(base + static_cast<size_t>(j1) * N + n) =
          make_float2(acc[nt][2], acc[nt][3]);
  }
}

// Block (chunk blockIdx.x, head group blockIdx.y, batch row blockIdx.z);
// warp w owns row blocks w and 7 - w of the chunk (see the note above).
template <int N, int P>
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_chunk(const bf16* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
              const bf16* __restrict__ bm, const bf16* __restrict__ cm,
              const bf16* __restrict__ dy, const float* __restrict__ st,
              const float* __restrict__ ust, bf16* __restrict__ dx, float* __restrict__ ddt,
              float* __restrict__ dbp, float* __restrict__ dcp, float* __restrict__ dap, int L,
              int H, int chunk, int hg) {
  constexpr int RN = N / 8, RP = P / 8, KN = N / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const ChunkSmem lay(N, P, hg);
  bf16* c_s = reinterpret_cast<bf16*>(smem + lay.c);
  bf16* b_s = reinterpret_cast<bf16*>(smem + lay.b);
  float* gt_s = reinterpret_cast<float*>(smem + lay.gt);
  bf16* h_s = reinterpret_cast<bf16*>(smem + lay.h);      // high plane, then low
  bf16* dy_s = reinterpret_cast<bf16*>(smem + lay.dy);
  bf16* dh_s = reinterpret_cast<bf16*>(smem + lay.dh);    // high plane, then low
  float* dt_s = reinterpret_cast<float*>(smem + lay.dt);
  float* cum2_s = reinterpret_cast<float*>(smem + lay.cum2);
  float* ecum_s = reinterpret_cast<float*>(smem + lay.ecum);
  float* w_s = reinterpret_cast<float*>(smem + lay.w);
  float* rq_s = reinterpret_cast<float*>(smem + lay.rq);
  float* dcum_s = reinterpret_cast<float*>(smem + lay.dcum);
  float* wsum_s = reinterpret_cast<float*>(smem + lay.wsum);
  float* red_s = reinterpret_cast<float*>(smem + lay.red);

  const int k = blockIdx.x, grp = blockIdx.y, b = blockIdx.z, nc = L / chunk;
  const int hf = grp * hg, nh = min(hg, H - hf);
  const int T = chunk, Tp = (T + 15) / 16 * 16, nrb = Tp / 16;
  const size_t row0 = static_cast<size_t>(b) * L + static_cast<size_t>(k) * T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, mi = lane >> 3;

  Ctx cx;
  cx.x = x;
  cx.dx = dx;
  cx.ddt = ddt;
  cx.c_s = c_s;
  cx.b_s = b_s;
  cx.dy_s = dy_s;
  cx.dh_s = dh_s;
  cx.h_s = h_s;
  cx.dg_s = reinterpret_cast<bf16*>(smem + lay.dg);
  cx.gt_s = gt_s;
  cx.dt_s = dt_s;
  cx.cum2_s = cum2_s;
  cx.ecum_s = ecum_s;
  cx.w_s = w_s;
  cx.rq_s = rq_s;
  cx.dcum_s = dcum_s;
  cx.row0 = row0;
  cx.H = H;
  cx.T = T;
  cx.nrb = nrb;
  cx.warp = warp;
  cx.lane = lane;
  cx.mi = mi;
  cx.gq = lane >> 2;
  cx.qd = lane & 3;
  const bool on0 = warp < nrb, on1 = 7 - warp < nrb;

  load_tile<RN>(c_s, cm + row0 * N, N, T, Tp);
  load_tile<RN>(b_s, bm + row0 * N, N, T, Tp);
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  __syncthreads();

  // G^T = B C^T, once for every head: tiles (J, I >= J) of the warp's row
  // blocks, each thread's fragments in its own slot
  for (int r = 0; r < 2; ++r) {
    const int J = r ? 7 - warp : warp;
    if (J >= nrb) continue;
    uint32_t ba[KN][4];
#pragma unroll
    for (int kk = 0; kk < KN; ++kk)
      mma::ldsm_x4(ba[kk], b_s + swz<RN>(16 * J + (mi & 1) * 8 + (lane & 7), 2 * kk + (mi >> 1)));
    for (int t = 0; J + t < nrb; ++t) {
      const int I = J + t;
      float g2[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int e = 0; e < 4; ++e) g2[half][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) {
        uint32_t cb[4];
        mma::ldsm_x4(cb, c_s + swz<RN>(16 * I + (mi >> 1) * 8 + (lane & 7), 2 * kk + (mi & 1)));
        mma::mma_bf16(g2[0], ba[kk], cb[0], cb[1]);
        mma::mma_bf16(g2[1], ba[kk], cb[2], cb[3]);
      }
      float4* slot = reinterpret_cast<float4*>(gt_s) +
                     (warp * kSlots + (r ? tile_slot<1>(t) : tile_slot<0>(t))) * 64 + lane;
      slot[0] = make_float4(g2[0][0], g2[0][1], g2[0][2], g2[0][3]);
      slot[32] = make_float4(g2[1][0], g2[1][1], g2[1][2], g2[1][3]);
    }
  }

  // ---- loop 1 over the heads; dG^T summed in registers, the nine tiles
  // of the warp's row blocks (tile_slot)
  float dg[2 * kSlots][4];
#pragma unroll
  for (int i = 0; i < 2 * kSlots; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dg[i][e] = 0.f;

  for (int hh = 0; hh < nh; ++hh) {
    const int hd = hf + hh;
    const size_t slot = (static_cast<size_t>(b) * nc + k) * H + hd;
    load_tile<RP>(dy_s, dy + (row0 * H + hd) * P, static_cast<size_t>(H) * P, T, Tp);
    load_dt(dt_s, dt + row0 * H + hd, H, T, Tp);
    load_state<N, P>(dh_s, ust + slot * N * P);
    mma::cp_async_commit();
    mma::cp_async_wait<0>();
    __syncthreads();
    if (warp == 0) chunk_cumsum(dt_s, a[hd], T, Tp, cum2_s, ecum_s, w_s);
    __syncthreads();
    float wpart = 0.f;
    if (on0) loop1_rows<N, P, 0>(dg, cx, hh, hd, wpart);
    if (on1) loop1_rows<N, P, 1>(dg, cx, hh, hd, wpart);
    wpart = rt::warp_sum(wpart);
    if (lane == 0) wsum_s[hh * kWarps + warp] = wpart;
    __syncthreads();
    // the row sums of dS (.) S: the column parts of row blocks J <= I, in order
    for (int i = threadIdx.x; i < T; i += kThreads) {
      float s = 0.f;
      for (int J = 0; J <= i / 16; ++J) s += rq_s[J * kRows + i];
      dcum_s[hh * kRows + i] += s;
    }
  }
  __syncthreads();   // every read of G^T, dy and dh is done

  // ---- dG^T to shared memory, then dB_intra = dG^T C (registers) and
  // dC_intra = dG B (dG read transposed)
  float db0[N / 8][4], db1[N / 8][4], dc0[N / 8][4], dc1[N / 8][4];
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) db0[nt][e] = db1[nt][e] = dc0[nt][e] = dc1[nt][e] = 0.f;
  if (on0) store_dg<0>(dg, cx);
  if (on1) store_dg<1>(dg, cx);
  if (on0) db_intra<N, 0>(db0, dg, cx);
  if (on1) db_intra<N, 1>(db1, dg, cx);
  __syncthreads();
  if (on0) dc_intra<N>(dc0, cx, 0);
  if (on1) dc_intra<N>(dc1, cx, 1);
  __syncthreads();   // dG^T is read; its region takes h

  // ---- loop 2 over the heads: the terms with h and dh, the decay term,
  // then d(ldec), ddt and dA's part
  for (int hh = 0; hh < nh; ++hh) {
    const int hd = hf + hh;
    const size_t slot = (static_cast<size_t>(b) * nc + k) * H + hd;
    load_tile<RP>(dy_s, dy + (row0 * H + hd) * P, static_cast<size_t>(H) * P, T, Tp);
    load_dt(dt_s, dt + row0 * H + hd, H, T, Tp);
    load_state<N, P>(h_s, st + slot * N * P);
    load_state<N, P>(dh_s, ust + slot * N * P);
    mma::cp_async_commit();
    mma::cp_async_wait<0>();
    __syncthreads();
    if (warp == 0) {
      const float decay = chunk_cumsum(dt_s, a[hd], T, Tp, cum2_s, ecum_s, w_s);
      if (lane == 0) red_s[kWarps] = decay;
    }
    // sum(dh (.) h) over the state, from the high + low parts, in order
    float dot = 0.f;
    for (int i = threadIdx.x; i < N * P / 2; i += kThreads) {
      const int n = 2 * i / P, p = 2 * i % P;
      const int off = swz<RP>(n, p / 8) + p % 8;
      const float2 h1 = mma::unpack_bf16(*reinterpret_cast<const uint32_t*>(h_s + off));
      const float2 h2 = mma::unpack_bf16(*reinterpret_cast<const uint32_t*>(h_s + N * P + off));
      const float2 g1 = mma::unpack_bf16(*reinterpret_cast<const uint32_t*>(dh_s + off));
      const float2 g2 = mma::unpack_bf16(*reinterpret_cast<const uint32_t*>(dh_s + N * P + off));
      dot += (h1.x + h2.x) * (g1.x + g2.x) + (h1.y + h2.y) * (g1.y + g2.y);
    }
    dot = rt::warp_sum(dot);
    if (lane == 0) red_s[warp] = dot;
    __syncthreads();
    if (on0) loop2_rows<N, P>(db0, dc0, cx, 0, hh, hd);
    if (on1) loop2_rows<N, P>(db1, dc1, cx, 1, hh, hd);
    __syncthreads();
    // dcum (the decay and w sums on the last row), d(ldec) as its reverse
    // cumsum (one warp, 4 rows a lane); ddt += a d(ldec); dA's part
    if (warp == 0) {
      const float ah = a[hd], decay = red_s[kWarps];
      float dsum = 0.f, wsum = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        dsum += red_s[w];
        wsum += wsum_s[hh * kWarps + w];
      }
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = lane * 4 + e;
        v[e] = r < T ? dcum_s[hh * kRows + r] : 0.f;
        if (r == T - 1) v[e] += wsum + decay * dsum;
      }
      float run = 0.f;
#pragma unroll
      for (int e = 3; e >= 0; --e) {
        run += v[e];
        v[e] = run;
      }
      float post = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_down_sync(0xffffffffu, post, off);
        if (lane + off < 32) post += o;
      }
      post -= run;   // the sum of the lanes after this one
      float da_lane = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = lane * 4 + e;
        if (r < T) {
          const float dl = v[e] + post;
          ddt[(row0 + r) * H + hd] += ah * dl;
          da_lane += dl * dt_s[r];
        }
      }
      const float da = rt::warp_sum(da_lane);
      if (lane == 0) dap[slot] = da;
    }
    __syncthreads();   // the next head's loads overwrite what was read
  }

  const size_t part = (static_cast<size_t>(b) * gridDim.y + grp) * L + static_cast<size_t>(k) * T;
  if (on0) {
    store_part<N>(dbp + part * N, db0, cx, 0);
    store_part<N>(dcp + part * N, dc0, cx, 0);
  }
  if (on1) {
    store_part<N>(dbp + part * N, db1, cx, 1);
    store_part<N>(dcp + part * N, dc1, cx, 1);
  }
}

// ---- (d) the fixed-order sums ---------------------------------------------------
// db[b, l, n] = sum_g dbp[b, g, l, n] (dc alike), groups in order; da[h] =
// sum over rows and chunks of dap[b, k, h], in order.  4 values a thread.
__global__ void __launch_bounds__(256)
ssd_bwd_sums(const float* __restrict__ dbp, const float* __restrict__ dcp,
              const float* __restrict__ dap, bf16* __restrict__ db, bf16* __restrict__ dc,
              float* __restrict__ da, int B, int L, int N, int G, int nc, int H) {
  const long long LN4 = static_cast<long long>(L) * N / 4;
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (i < B * LN4) {
    const long long bb = i / LN4, rem = i % LN4;
    float4 sb = make_float4(0.f, 0.f, 0.f, 0.f), sc = sb;
    for (int g = 0; g < G; ++g) {
      const long long at = (bb * G + g) * LN4 + rem;
      const float4 u = reinterpret_cast<const float4*>(dbp)[at];
      const float4 v = reinterpret_cast<const float4*>(dcp)[at];
      sb.x += u.x; sb.y += u.y; sb.z += u.z; sb.w += u.w;
      sc.x += v.x; sc.y += v.y; sc.z += v.z; sc.w += v.w;
    }
    reinterpret_cast<uint2*>(db)[i] = make_uint2(mma::pack_bf16(sb.x, sb.y), mma::pack_bf16(sb.z, sb.w));
    reinterpret_cast<uint2*>(dc)[i] = make_uint2(mma::pack_bf16(sc.x, sc.y), mma::pack_bf16(sc.z, sc.w));
  }
  if (blockIdx.x == 0)
    for (int h = threadIdx.x; h < H; h += 256) {
      float s = 0.f;
      for (int bk = 0; bk < B * nc; ++bk) s += dap[static_cast<size_t>(bk) * H + h];
      da[h] = s;
    }
}

template <int N, int P>
cudaError_t set_attrs() {
  static const cudaError_t attr = [] {   // once per process: the largest head group's need
    const cudaError_t e = rt::set_smem(ssd_bwd_states<N, P>, StatesSmem(N, P).total);
    return e != cudaSuccess ? e : rt::set_smem(ssd_bwd_chunk<N, P>, ChunkSmem(N, P, kMaxHeads).total);
  }();
  return attr;
}

template <int N, int P>
cudaError_t launch(const bf16* x, const float* dt, const float* a, const bf16* b, const bf16* c,
                   const float* h0, const bf16* dy, const float* dh_final, float* st, float* ust,
                   float* dec, float* dbp, float* dcp, float* dap, bf16* dx, float* ddt, bf16* db,
                   bf16* dc, float* da, float* dh0, int B, int L, int H, int chunk, int hg,
                   cudaStream_t s) {
  if (hg < 1 || hg > kMaxHeads) return cudaErrorInvalidValue;
  cudaError_t err = set_attrs<N, P>();
  if (err != cudaSuccess) return err;
  const int nc = L / chunk, G = (H + hg - 1) / hg;
  const dim3 grid(nc, G, B);
  ssd_bwd_states<N, P><<<grid, kThreads, StatesSmem(N, P).total, s>>>(
      x, dt, a, b, c, dy, st, ust, dec, L, H, chunk, hg);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long threads = static_cast<long long>(B) * H * N * P / 8;
  ssd_bwd_pass<<<static_cast<unsigned>((threads + 255) / 256), 256, 0, s>>>(
      st, ust, dec, h0, dh_final, dh0, B, H, nc, N * P);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_chunk<N, P><<<grid, kThreads, ChunkSmem(N, P, hg).total, s>>>(
      x, dt, a, b, c, dy, st, ust, dx, ddt, dbp, dcp, dap, L, H, chunk, hg);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long n4 = static_cast<long long>(B) * L * N / 4;
  ssd_bwd_sums<<<static_cast<unsigned>((n4 + 255) / 256), 256, 0, s>>>(
      dbp, dcp, dap, db, dc, da, B, L, N, G, nc, H);
  return cudaGetLastError();
}

// Resident blocks per SM of ssd_bwd_chunk at hg heads (or -1 on an error).
template <int N, int P>
int occupancy(int hg) {
  if (set_attrs<N, P>() != cudaSuccess) return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ssd_bwd_chunk<N, P>, kThreads,
                                                    ChunkSmem(N, P, hg).total) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace bwdtc

// The backward of ssd_scan_launch in f32 (the FMA body).  x, b, c, dy and
// dx, db, dc f32, as dt, a, h0, dh_final, ddt, da, dh0; h0 / dh_final null
// for zeros, dh0 null when not wanted.  Scratch (f32): hs [B, H, L /
// chunk, N, P], dbp and dcp [B, H, L, N], dap [B, H].  Two launches on
// `stream`: the scan backward and the reduction over heads and rows.
extern "C" int ssd_scan_bwd_launch(const void* x, const void* dt, const void* a, const void* b,
                                   const void* c, const void* h0, const void* dy,
                                   const void* dh_final, void* hs, void* dbp, void* dcp,
                                   void* dap, void* dx, void* ddt, void* db, void* dc, void* da,
                                   void* dh0, int B, int L, int H, int P, int N, int chunk,
                                   int dtype, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0) return cudaSuccess;
  if (chunk < 1 || chunk > kMaxT || L % chunk != 0) return cudaErrorInvalidValue;
  if (dtype != rt::kF32) return cudaErrorInvalidValue;   // bf16: ssd_scan_bwd_tc_launch
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto g = [](void* p) { return static_cast<float*>(p); };
  return bwd::dispatch(N, P, f(x), f(dt), f(a), f(b), f(c), f(h0), f(dy), f(dh_final), g(hs),
                       g(dbp), g(dcp), g(dap), g(dx), g(ddt), g(db), g(dc), g(da), g(dh0), B, L,
                       H, chunk, static_cast<cudaStream_t>(stream));
}

// The backward of ssd_scan_launch in bf16 (the tensor-core body).  x, b,
// c, dy, dx, db, dc bf16; dt, a, h0, dh_final, ddt, da, dh0 f32; h0 /
// dh_final null for zeros, dh0 null when not wanted.  Scratch (f32): st,
// ust [B, L / chunk, H, N, P]; dec, dap [B, L / chunk, H]; dbp, dcp [B,
// ceil(H / hg), L, N].  hg heads a block (1..8).  Four launches on
// `stream`: states, state passing, chunk gradients, the sums over head
// groups, rows and chunks.
extern "C" int ssd_scan_bwd_tc_launch(const void* x, const void* dt, const void* a,
                                      const void* b, const void* c, const void* h0,
                                      const void* dy, const void* dh_final, void* st, void* ust,
                                      void* dec, void* dbp, void* dcp, void* dap, void* dx,
                                      void* ddt, void* db, void* dc, void* da, void* dh0, int B,
                                      int L, int H, int P, int N, int chunk, int hg,
                                      void* stream) {
  if (B <= 0 || H <= 0 || L <= 0) return cudaSuccess;
  if (chunk < 1 || chunk > kMaxT || L % chunk != 0) return cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto g = [](void* p) { return static_cast<float*>(p); };
  const auto cb = [](const void* p) { return static_cast<const bf*>(p); };
  const auto mb = [](void* p) { return static_cast<bf*>(p); };
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SSD_BWD_TC_CASE(NN, PP)                                                                  \
  if (N == NN && P == PP)                                                                        \
    return bwdtc::launch<NN, PP>(cb(x), f(dt), f(a), cb(b), cb(c), f(h0), cb(dy), f(dh_final),  \
                                 g(st), g(ust), g(dec), g(dbp), g(dcp), g(dap), mb(dx), g(ddt),  \
                                 mb(db), mb(dc), g(da), g(dh0), B, L, H, chunk, hg, s);
  SSD_BWD_TC_CASE(16, 32) SSD_BWD_TC_CASE(16, 64) SSD_BWD_TC_CASE(32, 32)
  SSD_BWD_TC_CASE(32, 64) SSD_BWD_TC_CASE(64, 32) SSD_BWD_TC_CASE(64, 64)
#undef SSD_BWD_TC_CASE
  return cudaErrorInvalidValue;
}

// Resident blocks per SM of the bf16 backward's chunk-gradient launch at
// hg heads a block (-1 on an error or an uncompiled (N, P)); the tests
// hold it to two at every head group.
extern "C" int ssd_scan_bwd_occupancy(int N, int P, int hg) {
#define SSD_OCC_CASE(NN, PP) \
  if (N == NN && P == PP) return bwdtc::occupancy<NN, PP>(hg);
  SSD_OCC_CASE(16, 32) SSD_OCC_CASE(16, 64) SSD_OCC_CASE(32, 32)
  SSD_OCC_CASE(32, 64) SSD_OCC_CASE(64, 32) SSD_OCC_CASE(64, 64)
#undef SSD_OCC_CASE
  return -1;
}

// x: [B, L, H, P] (dtype); dt: [B, L, H] f32; a: [H] f32; b, c: [B, L, N]
// (dtype); h0: [B, H, N, P] f32 or null (zeros); y: [B, L, H, P] (dtype);
// h: [B, H, N, P] f32.  L a multiple of chunk, 1 <= chunk <= 128; (N, P)
// one of the compiled pairs.  Returns the launch's CUDA error.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a, const void* b,
                               const void* c, const void* h0, void* y, void* h, int B, int L,
                               int H, int P, int N, int chunk, int hg, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0) return cudaSuccess;
  if (chunk < 1 || chunk > kMaxT || L % chunk != 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  const float* h0f = static_cast<const float*>(h0);
  float* hf = static_cast<float*>(h);
  switch (dtype) {
    case rt::kBF16:
      return tc::dispatch(N, x, dtf, af, b, c, h0f, y, hf, B, L, H, P, chunk, hg, s);
    case rt::kF32:
      return dispatch<float>(N, P, x, dtf, af, b, c, h0f, y, hf, B, L, H, chunk, s);
    default: return cudaErrorInvalidValue;
  }
}
