// PTX wrappers for the tensor-core kernels: cp.async and TMA copies,
// mbarriers, wgmma (warpgroup matrix multiply-accumulate, sm_90a) and the
// one-warp mma.sync m16n8k16 with its ldmatrix loads, on bf16 with f32
// accumulation.
//
// A wgmma of shape m64nNk16 is issued by the 128 threads of a warpgroup.
// Register layouts (warp w of the warpgroup owns rows 16w .. 16w + 15;
// g = lane / 4, q = lane % 4), which the kernels index by hand:
//   A in registers (16 x 16 per warp): a0: [g][2q, 2q+1]  a1: [g+8][2q..]
//                                      a2: [g][8+2q..]   a3: [g+8][8+2q..]
//   D (f32, 16 x N per warp): d[n][0], d[n][1]: [g][8n + 2q, +1]
//                             d[n][2], d[n][3]: [g+8][8n + 2q, +1]
// So the D tile of one product, rounded to bf16, is the register A operand
// of a product over its columns (to_a below).  Operands in shared memory
// are described by a 64-bit descriptor (make_desc) of a tile in the
// canonical swizzled layout.
#pragma once

#include <cuda.h>   // CUtensorMap
#include <cuda_bf16.h>
#include <stdint.h>

namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy global -> shared that does not block; `valid` false reads
// nothing and fills 16 zero bytes (src must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4-byte copy global -> shared, zero-filled when `valid` is false.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// mbarrier in shared memory that completes when `count` threads arrive and
// the bytes they announced have landed.  Call from one thread, then
// mbar_init_fence and a barrier before any thread uses it.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive on bar and announce `bytes` that copies will complete on it.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Arrive on bar (one count of its expected arrivals).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Wait until the phase of bar with parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// TMA: the box at coordinates (x, y, z) of a 3-D tensor map (a kernel
// parameter) into shared memory, completing its bytes on bar.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int x, int y, int z,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(smem_addr(bar))
      : "memory");
}

// Make this thread's completed shared-memory writes (cp.async lands them
// through the generic proxy) visible to wgmma, which reads through the
// async proxy; a barrier must follow before another thread's wgmma.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Order earlier register and shared-memory writes before the wgmmas that
// follow (required before the first wgmma of a batch).
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed wgmma groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers in place around wgmma: the compiler may not move their
// reads or writes across this point (wgmma writes its D asynchronously).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+f"(r[i][j])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Move this warpgroup's register budget to N a thread (a multiple of 8
// in [24, 256]; every thread of the warpgroup executes it): dec gives
// registers back to the block's pool, inc waits for them.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (multiples of 16), layout (1: 128-byte swizzle, 2: 64-byte).
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo, uint32_t sbo,
                                              uint32_t layout) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | static_cast<uint64_t>(layout) << 62;
}

// d[OFF, OFF + 8) += A B^T, m64n64k16: A and B K-major in shared memory.
template <int OFF, int NT>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[NT][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[OFF + 0][0]), "+f"(d[OFF + 0][1]), "+f"(d[OFF + 0][2]), "+f"(d[OFF + 0][3]),
        "+f"(d[OFF + 1][0]), "+f"(d[OFF + 1][1]), "+f"(d[OFF + 1][2]), "+f"(d[OFF + 1][3]),
        "+f"(d[OFF + 2][0]), "+f"(d[OFF + 2][1]), "+f"(d[OFF + 2][2]), "+f"(d[OFF + 2][3]),
        "+f"(d[OFF + 3][0]), "+f"(d[OFF + 3][1]), "+f"(d[OFF + 3][2]), "+f"(d[OFF + 3][3]),
        "+f"(d[OFF + 4][0]), "+f"(d[OFF + 4][1]), "+f"(d[OFF + 4][2]), "+f"(d[OFF + 4][3]),
        "+f"(d[OFF + 5][0]), "+f"(d[OFF + 5][1]), "+f"(d[OFF + 5][2]), "+f"(d[OFF + 5][3]),
        "+f"(d[OFF + 6][0]), "+f"(d[OFF + 6][1]), "+f"(d[OFF + 6][2]), "+f"(d[OFF + 6][3]),
        "+f"(d[OFF + 7][0]), "+f"(d[OFF + 7][1]), "+f"(d[OFF + 7][2]), "+f"(d[OFF + 7][3])
      : "l"(da), "l"(db), "r"(1));
}

// d[OFF, OFF + 4) += A B^T, m64n32k16: A and B K-major in shared memory.
template <int OFF, int NT>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[NT][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[OFF + 0][0]), "+f"(d[OFF + 0][1]), "+f"(d[OFF + 0][2]), "+f"(d[OFF + 0][3]),
        "+f"(d[OFF + 1][0]), "+f"(d[OFF + 1][1]), "+f"(d[OFF + 1][2]), "+f"(d[OFF + 1][3]),
        "+f"(d[OFF + 2][0]), "+f"(d[OFF + 2][1]), "+f"(d[OFF + 2][2]), "+f"(d[OFF + 2][3]),
        "+f"(d[OFF + 3][0]), "+f"(d[OFF + 3][1]), "+f"(d[OFF + 3][2]), "+f"(d[OFF + 3][3])
      : "l"(da), "l"(db), "r"(1));
}

// d[OFF, OFF + 8) += A B, m64n64k16: A in registers (per warp, the
// mma.m16n8k16 A layout of its 16 rows), B MN-major in shared memory.
template <int OFF, int NT>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[NT][4], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[OFF + 0][0]), "+f"(d[OFF + 0][1]), "+f"(d[OFF + 0][2]), "+f"(d[OFF + 0][3]),
        "+f"(d[OFF + 1][0]), "+f"(d[OFF + 1][1]), "+f"(d[OFF + 1][2]), "+f"(d[OFF + 1][3]),
        "+f"(d[OFF + 2][0]), "+f"(d[OFF + 2][1]), "+f"(d[OFF + 2][2]), "+f"(d[OFF + 2][3]),
        "+f"(d[OFF + 3][0]), "+f"(d[OFF + 3][1]), "+f"(d[OFF + 3][2]), "+f"(d[OFF + 3][3]),
        "+f"(d[OFF + 4][0]), "+f"(d[OFF + 4][1]), "+f"(d[OFF + 4][2]), "+f"(d[OFF + 4][3]),
        "+f"(d[OFF + 5][0]), "+f"(d[OFF + 5][1]), "+f"(d[OFF + 5][2]), "+f"(d[OFF + 5][3]),
        "+f"(d[OFF + 6][0]), "+f"(d[OFF + 6][1]), "+f"(d[OFF + 6][2]), "+f"(d[OFF + 6][3]),
        "+f"(d[OFF + 7][0]), "+f"(d[OFF + 7][1]), "+f"(d[OFF + 7][2]), "+f"(d[OFF + 7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[OFF, OFF + 4) += A B, m64n32k16: A in registers (per warp, the
// mma.m16n8k16 A layout of its 16 rows), B MN-major in shared memory.
template <int OFF, int NT>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[NT][4], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[OFF + 0][0]), "+f"(d[OFF + 0][1]), "+f"(d[OFF + 0][2]), "+f"(d[OFF + 0][3]),
        "+f"(d[OFF + 1][0]), "+f"(d[OFF + 1][1]), "+f"(d[OFF + 1][2]), "+f"(d[OFF + 1][3]),
        "+f"(d[OFF + 2][0]), "+f"(d[OFF + 2][1]), "+f"(d[OFF + 2][2]), "+f"(d[OFF + 2][3]),
        "+f"(d[OFF + 3][0]), "+f"(d[OFF + 3][1]), "+f"(d[OFF + 3][2]), "+f"(d[OFF + 3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B, m64n256k16: A K-major and B MN-major (256 columns: four
// 64-column swizzle atoms, the descriptor's leading byte offset
// apart), both in shared memory.
__device__ __forceinline__ void wgmma_ss_n256_tb(float (&d)[32][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
        "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
        "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
        "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
        "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
        "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]),
        "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
        "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]),
        "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
      : "l"(da), "l"(db), "r"(1));
}

// mma.sync m16n8k16 (one warp): d += A B, bf16 in, f32 accumulate.  A in
// the register layout above (a0..a3); B (16 x 8, k x n): b0 holds
// [k 2q, 2q+1][n g], b1 [k 8+2q, 9+2q][n g]; d as one 16 x 8 D tile.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ldmatrix: four 8 x 8 bf16 matrices from shared memory, lanes 8i .. 8i + 7
// giving the row addresses of matrix i; r[i] is this lane's pair of matrix
// i ([row lane / 4][cols 2 (lane % 4), +1]; transposed: [rows 2 (lane % 4),
// +1][col lane / 4]).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// Two matrices (lanes 0-15 give the row addresses).
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(row)));
}

// Two matrices (lanes 0-15 give the row addresses), transposed.
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(row)));
}

// Two f32 values rounded (nearest even) to a bf16 pair, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The two f32 values of a bf16 pair (low half first).
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
}

// The A operand of a product over the 8N columns of a 16 x 8N D tile.
template <int N>
__device__ __forceinline__ void to_a(uint32_t (&a)[N / 2][4], const float (&c)[N][4]) {
#pragma unroll
  for (int k = 0; k < N / 2; ++k) {
    a[k][0] = pack_bf16(c[2 * k][0], c[2 * k][1]);
    a[k][1] = pack_bf16(c[2 * k][2], c[2 * k][3]);
    a[k][2] = pack_bf16(c[2 * k + 1][0], c[2 * k + 1][1]);
    a[k][3] = pack_bf16(c[2 * k + 1][2], c[2 * k + 1][3]);
  }
}

}  // namespace mma
