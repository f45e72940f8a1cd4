// Tensor-core pieces of the bf16 flash kernels (flash_fwd.cu's
// flash_fwd_tc_kernel, flash_bwd.cu's flash_bwd_dq_tc_kernel and
// flash_bwd_dkv_tc_kernel), in inline PTX for sm_90a: 16-byte cp.async
// copies into a 128-byte-swizzled shared layout, the wgmma shared-memory
// descriptor of that layout, and the two warpgroup products the kernels
// need, both m64n64k16 bf16 -> fp32:
//   wgmma_ss    A and B from shared memory, both K-major (S = Q K^T,
//               dP = dO V^T: a K or V tile [key][d] is K-major in d; and
//               transposed, S^T = K Q^T, dP^T = V dO^T);
//   wgmma_rs_t  A from registers, B from shared memory MN-major (O += P V,
//               dQ += dS K: the same [key][d] tile read with the
//               transpose bit; dV += P^T dO, dK += dS^T Q: a [query][d]
//               Q or dO tile read the same way).
// The fp32 accumulator of a 64 x 64 product is, register for register,
// the A fragment of the next product once rounded to bf16 (see
// acc_to_a), so P and dS never pass through shared memory.
//
// What bounds the kernels built on it: arithmetic.  At the training shape
// (B 4, S 2048, nh 16, hd 128, causal) the forward does 68.75 GFLOP, the
// dq kernel 103.1 and the dk/dv kernel 137.5: 0.0695, 0.1043 and 0.1390
// ms at the H100's 989 TFLOP/s dense bf16, against 1.03, 1.54 and 2.05 ms
// at the 67 TFLOP/s of fp32 FMAs.  These pieces move the products onto the tensor cores; operands
// stay bf16 in shared memory (half the bytes of the fp32 tiles), and
// copies of the next key tile overlap the products on the current one.
//
// Shared layout ("SW128").  A tile of R rows by C bf16 columns (C a
// multiple of 64) is stored as C / 64 column blocks of R rows x 128 bytes;
// in row r the 16-byte chunk c of a block sits at chunk c ^ (r % 8).  This
// is the layout that TMA's 128-byte swizzle writes and the one wgmma's
// 128-byte swizzle mode reads: the eight rows of a core matrix then fall
// in eight different bank groups.  Every block starts 1024-byte aligned.
// A step of 16 columns (one k-step of a K-major operand) adds 32 bytes to
// the descriptor's start address; a step of 16 rows (one k-step of an
// MN-major operand) adds 2048 bytes.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace ptt {
namespace tc {

constexpr int kRowBytes = 128;      // one SW128 row: 64 bf16
constexpr int kGroupBytes = 1024;   // eight rows: one swizzle atom

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk `c` (of D / 8) of row `r` in an SW128 tile
// of `rows` rows.
__device__ __forceinline__ uint32_t sw128_offset(int r, int c, int rows) {
  return (uint32_t)((c >> 3) * rows * kRowBytes + r * kRowBytes +
                    (((c & 7) ^ (r & 7)) << 4));
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 writes zeros and
// reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait for this thread's copies, then make them visible to wgmma (the
// async proxy); a barrier must follow before other threads' wgmma reads.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Copy `rows` rows of D bf16 into an SW128 tile; row r comes from
// base + row_off(r) (elements), or is zeros when row_off(r) < 0.  All
// `nthreads` threads of the block take part.
template <int D, int NTHREADS, class RowOff>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* base,
                                          int rows, RowOff row_off) {
  constexpr int C = D / 8;
  for (int idx = threadIdx.x; idx < rows * C; idx += NTHREADS) {
    const int r = idx / C, c = idx % C;
    const long long o = row_off(r);
    const __nv_bfloat16* src = o >= 0 ? base + o + c * 8 : base;
    cp_async16(dst + sw128_offset(r, c, rows), src, o >= 0 ? 16 : 0);
  }
}

constexpr int kKeys = 64;           // keys per K/V tile

// Key tile k0 .. k0 + 63 of (batch b, kv head hk) of k, v [B, Sk, nkv, D]:
// the K and V rows into the SW128 tiles at kdst and vdst, each key's
// valid flag into kok[64].  A key past Sk or masked out by the [B, Sk]
// mask (null: none) is zeros and flag 0, and is never read.
template <int D, int NTHREADS>
__device__ __forceinline__ void load_kv_tile(
    uint32_t kdst, uint32_t vdst, int* kok, const __nv_bfloat16* k,
    const __nv_bfloat16* v, const int* mask, int b, int Sk, int nkv, int hk,
    int k0) {
  auto off = [=](int r) -> long long {
    const int kp = k0 + r;
    if (kp >= Sk) return -1;
    const long long row = b * (long long)Sk + kp;
    if (mask != nullptr && mask[row] == 0) return -1;
    return (row * nkv + hk) * D;
  };
  load_tile<D, NTHREADS>(kdst, k, kKeys, off);
  load_tile<D, NTHREADS>(vdst, v, kKeys, off);
  if (threadIdx.x < kKeys) kok[threadIdx.x] = off(threadIdx.x) >= 0;
}

// wgmma descriptor of an SW128 operand starting at shared address `addr`:
// start address >> 4 in bits 0-13, leading byte offset in 16-29, stride
// byte offset in 32-45 (both in 16-byte units), swizzle mode in 62-63
// (1 = 128 bytes).  The stride byte offset is the step between groups of
// eight rows (1024 bytes here) in both majors.  The leading byte offset
// is not read for a K-major SW128 operand, and for an MN-major one only
// when N spans more than one 64-wide block, which these kernels never
// ask; it is set to the same 1024 bytes.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  constexpr uint64_t off = kGroupBytes >> 4;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (off << 16) | (off << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin registers at this point of the program: the compiler may not move
// their reads or writes across it.  Called on accumulators and register
// operands after a wgmma_wait_all, since the hardware writes (reads) them
// until then, not where the wgmma instruction stands.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define PTT_D32(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])
#define PTT_D32_LIST                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (+)= A B for a 64 x 64 x 16 step, A and B K-major in shared memory.
// accumulate 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PTT_D32_LIST
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : PTT_D32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B for a 64 x 64 x 16 step, A the register fragment a[4] (bf16
// pairs), B MN-major in shared memory (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_t(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PTT_D32_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : PTT_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef PTT_D32
#undef PTT_D32_LIST

// Accumulator layout of a 64 x 64 fp32 wgmma result in the warpgroup:
// warp w holds rows 16 w .. 16 w + 15; lane l (g = l / 4, t = l % 4)
// holds, for each 8-column block j, d[4j], d[4j+1] at row g, columns
// 8j + 2t, 8j + 2t + 1, and d[4j+2], d[4j+3] at row g + 8, same columns.
__device__ __forceinline__ int acc_col(int i, int t) {
  return (i >> 2) * 8 + 2 * t + (i & 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of k-step kk (columns 16 kk .. 16 kk + 15) of a 64 x 64
// accumulator, rounded to bf16: registers {row g, cols 2t..}, {row g + 8},
// {row g, cols 8 + 2t..}, {row g + 8, cols 8 + 2t..} -- exactly the
// accumulator's d[8kk .. 8kk + 7] in pairs.
__device__ __forceinline__ void acc_to_a(const float (&d)[32], int kk,
                                         uint32_t (&a)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
    a[r] = pack_bf16(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}

// Rows g and g + 8 of a warp's share of a 64 x (64 NB) accumulator
// (column block nb in acc[nb]), times scale[r], as bf16 into the rows
// row[r] < Sq of out [B, Sq, nh, W] at batch b, head h, columns col0 ..
// col0 + 64 NB - 1; lane t of the row's four writes 2 columns of each 8.
template <int NB, int W = 64 * NB>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float (&acc)[NB][32],
                                           const int (&row)[2],
                                           const float (&scale)[2], int Sq,
                                           int b, int nh, int h, int t,
                                           int col0 = 0) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= Sq) continue;
    __nv_bfloat16* dst =
        out + ((b * (long long)Sq + row[r]) * nh + h) * W + col0;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + nb * 64 + j * 8 + 2 * t) =
            pack_bf16(acc[nb][4 * j + 2 * r] * scale[r],
                      acc[nb][4 * j + 2 * r + 1] * scale[r]);
  }
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Round a shared-memory base up to the 1024 bytes a swizzle atom needs.
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_addr(p);
  return p + ((kGroupBytes - (a & (kGroupBytes - 1))) & (kGroupBytes - 1));
}

}  // namespace tc
}  // namespace ptt
