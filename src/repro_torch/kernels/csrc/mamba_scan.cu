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
// recurrence this kernel follows.
//
// Bound on an H100: bytes.  At the training shape (B 4, L 2048, H 80,
// P 64, N 64, T 128) it must read x and dy (2 x 84 MB in bf16), dt, b, c
// and write dx (84 MB), ddt, db, dc: ~260 MB, ~78 us at 3.35 TB/s; its
// products (~10 of the forward's [T, T] x [T, *] size a chunk) need about
// 50 GFLOP, ~51 us at the bf16 tensor-core peak.
//
// Design: correct first, every product on the FMA pipes in f32 (bf16
// inputs too), so this kernel is far from its bound; a later redesign
// puts the products on the tensor cores as the forward's.  One 256-thread
// block per (batch row, head), the 16 x 16 register tiles of the f32
// forward.  The chunk states are recomputed, not saved by the forward:
// the block first walks the chunks forward and writes the state before
// each into a scratch [B, H, L / T, N, P] f32 (84 MB at the training
// shape, live only during the call; saving it from the forward would
// keep that much per layer alive across the recomputed super-block).
// Then it walks the chunks in reverse carrying dh [N, P] in shared
// memory, and per chunk (staged as f32: dtx, dy, b, c, the cumsum, and
// S = (C B^T) (.) exp(cum_i - cum_j) in a [T, T] tile) forms d(dtx), dx
// and ddt (which sums over P inside the block), dS and from it dG and the
// decay terms, the per-head parts of dB and dC, and the new dh.
// Cross-block sums have no atomics, so every run gives the same bits:
// dB and dC sum over all H heads, so each block writes its head's f32
// part [B, H, L, N] and a second launch sums the heads in order; dA sums
// over rows and time, so each block writes its f32 sum and the second
// launch sums the rows in order.  Inside a block the row and column sums
// of dS (.) S, d(ldec)'s reverse cumsum and the decay term are reduced in
// a fixed order (shuffles, per-row partials in shared memory).
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

template <typename T, int N, int P>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
               const T* __restrict__ bm, const T* __restrict__ cm, const float* __restrict__ h0,
               const T* __restrict__ dy, const float* __restrict__ dh_final,
               float* __restrict__ hs, T* __restrict__ dx, float* __restrict__ ddt,
               float* __restrict__ dbp, float* __restrict__ dcp, float* __restrict__ dap,
               float* __restrict__ dh0, int L, int H, int chunk) {
  constexpr int V = rt::Vec<T>::n, PV = P / V, NV = N / V;
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

  // dtx = round(dt x), b, c, ldec of the chunk at l0 (and dy), pad rows 0;
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
        for (int j = 0; j < V; ++j) v[j] = rt::to_f(rt::from_f<T>(d * v[j]));
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
          dx[row * P + p] = rt::from_f<T>(g * d);
          xd += g * rt::to_f(x[row * P + p]);
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
template <typename T>
__global__ void ssd_bwd_reduce(const float* __restrict__ dbp, const float* __restrict__ dcp,
                               const float* __restrict__ dap, T* __restrict__ db,
                               T* __restrict__ dc, float* __restrict__ da, int B, int L, int H,
                               int N) {
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
    db[i] = rt::from_f<T>(sb);
    dc[i] = rt::from_f<T>(sc);
  }
  if (blockIdx.x == 0)
    for (int h = threadIdx.x; h < H; h += blockDim.x) {
      float s = 0.f;
      for (int bb = 0; bb < B; ++bb) s += dap[bb * H + h];
      da[h] = s;
    }
}

template <typename T, int N, int P>
cudaError_t launch_t(const void* x, const float* dt, const float* a, const void* b,
                     const void* c, const float* h0, const void* dy, const float* dh_final,
                     float* hs, float* dbp, float* dcp, float* dap, void* dx, float* ddt,
                     void* db, void* dc, float* da, float* dh0, int B, int L, int H, int chunk,
                     cudaStream_t stream) {
  auto kernel = ssd_bwd_kernel<T, N, P>;
  static const cudaError_t attr =   // once per process: the largest chunk's need
      rt::set_smem(kernel, smem_floats<N, P>(kMaxT) * sizeof(float));
  if (attr != cudaSuccess) return attr;
  const size_t smem = smem_floats<N, P>((chunk + 15) / 16 * 16) * sizeof(float);
  kernel<<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(b), static_cast<const T*>(c), h0,
      static_cast<const T*>(dy), dh_final, hs, static_cast<T*>(dx), ddt, dbp, dcp, dap, dh0, L,
      H, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = static_cast<long long>(B) * L * N;
  ssd_bwd_reduce<T><<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(
      dbp, dcp, dap, static_cast<T*>(db), static_cast<T*>(dc), da, B, L, H, N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int N, int P, const void* x, const float* dt, const float* a, const void* b,
                     const void* c, const float* h0, const void* dy, const float* dh_final,
                     float* hs, float* dbp, float* dcp, float* dap, void* dx, float* ddt,
                     void* db, void* dc, float* da, float* dh0, int B, int L, int H, int chunk,
                     cudaStream_t s) {
#define SSD_BWD_CASE(NN, PP)                                                                   \
  if (N == NN && P == PP)                                                                      \
    return launch_t<T, NN, PP>(x, dt, a, b, c, h0, dy, dh_final, hs, dbp, dcp, dap, dx, ddt,   \
                               db, dc, da, dh0, B, L, H, chunk, s);
  SSD_BWD_CASE(16, 32) SSD_BWD_CASE(16, 64) SSD_BWD_CASE(32, 32) SSD_BWD_CASE(32, 64)
  SSD_BWD_CASE(64, 32) SSD_BWD_CASE(64, 64)
#undef SSD_BWD_CASE
  return cudaErrorInvalidValue;
}

}  // namespace bwd

// The backward of ssd_scan_launch.  x, b, c, dy and dx, db, dc in the
// dtype; dt, a, h0, dh_final, ddt, da, dh0 f32; h0 / dh_final null for
// zeros, dh0 null when not wanted.  Scratch (f32): hs [B, H, L / chunk,
// N, P], dbp and dcp [B, H, L, N], dap [B, H].  Two launches on
// `stream`: the scan backward and the reduction over heads and rows.
extern "C" int ssd_scan_bwd_launch(const void* x, const void* dt, const void* a, const void* b,
                                   const void* c, const void* h0, const void* dy,
                                   const void* dh_final, void* hs, void* dbp, void* dcp,
                                   void* dap, void* dx, void* ddt, void* db, void* dc, void* da,
                                   void* dh0, int B, int L, int H, int P, int N, int chunk,
                                   int dtype, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0) return cudaSuccess;
  if (chunk < 1 || chunk > kMaxT || L % chunk != 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto g = [](void* p) { return static_cast<float*>(p); };
  switch (dtype) {
    case rt::kBF16:
      return bwd::dispatch<__nv_bfloat16>(N, P, x, f(dt), f(a), b, c, f(h0), dy, f(dh_final),
                                          g(hs), g(dbp), g(dcp), g(dap), dx, g(ddt), db, dc,
                                          g(da), g(dh0), B, L, H, chunk, s);
    case rt::kF32:
      return bwd::dispatch<float>(N, P, x, f(dt), f(a), b, c, f(h0), dy, f(dh_final), g(hs),
                                  g(dbp), g(dcp), g(dap), dx, g(ddt), db, dc, g(da), g(dh0), B,
                                  L, H, chunk, s);
    default: return cudaErrorInvalidValue;
  }
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
