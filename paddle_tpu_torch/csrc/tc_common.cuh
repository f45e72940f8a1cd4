// Tensor-core pieces of the 16-bit flash kernels (flash_fwd.cu's
// flash_fwd_tc_kernel, flash_bwd.cu's flash_bwd_dq_tc_kernel and
// flash_bwd_dkv_tc_kernel), in inline PTX for sm_90a: 16-byte cp.async
// copies into a 128-byte-swizzled shared layout, the wgmma shared-memory
// descriptor of that layout, and the warpgroup products the kernels need,
// m64n64k16 with 16-bit operands (bfloat16 or float16, the template
// argument T of each product) -> fp32:
//   wgmma_ss    A and B from shared memory, both K-major (S = Q K^T,
//               dP = dO V^T: a K or V tile [key][d] is K-major in d; and
//               transposed, S^T = K Q^T, dP^T = V dO^T);
//   wgmma_rs_t  A from registers, B from shared memory MN-major (O += P V,
//               dQ += dS K: the same [key][d] tile read with the
//               transpose bit; dV += P^T dO, dK += dS^T Q: a [query][d]
//               Q or dO tile read the same way).
//   wgmma_rs    A from registers, B K-major at n 64, 128 or 256
//               (weight_only_gemm.cu: y^T = W x^T, the dequantized codes
//               in registers, rows of x as TMA writes them; bf16 only).
// For weight_only_gemm.cu also the Hopper pipeline's pieces: mbarriers
// (init, arrive, expect_tx, parity wait), 2-D TMA loads that complete on
// an mbarrier, and setmaxnreg.
// The fp32 accumulator of a 64 x 64 product is, register for register,
// the A fragment of the next product once rounded to the 16-bit type (see
// acc_to_a: __floats2bfloat162_rn for bf16, __float22half2_rn for fp16),
// so P and dS never pass through shared memory.
//
// What bounds the kernels built on it: arithmetic.  At the training shape
// (B 4, S 2048, nh 16, hd 128, causal) the forward does 68.75 GFLOP, the
// dq kernel 103.1 and the dk/dv kernel 137.5: 0.0695, 0.1043 and 0.1390
// ms at the H100's 989 TFLOP/s dense bf16 or fp16, against 1.03, 1.54 and
// 2.05 ms at the 67 TFLOP/s of fp32 FMAs.  These pieces move the products
// onto the tensor cores; operands stay 16-bit in shared memory (half the
// bytes of the fp32 tiles), and copies of the next key tile overlap the
// products on the current one.
//
// Shared layout ("SW128").  A tile of R rows by C 16-bit columns (C a
// multiple of 64) is stored as C / 64 column blocks of R rows x 128 bytes;
// in row r the 16-byte chunk c of a block sits at chunk c ^ (r % 8).  This
// is the layout that TMA's 128-byte swizzle writes and the one wgmma's
// 128-byte swizzle mode reads: the eight rows of a core matrix then fall
// in eight different bank groups.  Every block starts 1024-byte aligned.
// A step of 16 columns (one k-step of a K-major operand) adds 32 bytes to
// the descriptor's start address; a step of 16 rows (one k-step of an
// MN-major operand) adds 2048 bytes.  Layout, copies and descriptors are
// the same for both 16-bit types; only the products' type strings and the
// rounding of a fragment differ.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace ptt {
namespace tc {

constexpr int kRowBytes = 128;      // one SW128 row: 64 16-bit values
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

// Copy `rows` rows of D 16-bit values (T: bf16 or fp16) into an SW128
// tile; row r comes from base + row_off(r) (elements), or is zeros when
// row_off(r) < 0.  All `nthreads` threads of the block take part.
template <int D, int NTHREADS, class T, class RowOff>
__device__ __forceinline__ void load_tile(uint32_t dst, const T* base,
                                          int rows, RowOff row_off) {
  static_assert(sizeof(T) == 2, "SW128 tiles hold 16-bit values");
  constexpr int C = D / 8;
  for (int idx = threadIdx.x; idx < rows * C; idx += NTHREADS) {
    const int r = idx / C, c = idx % C;
    const long long o = row_off(r);
    const T* src = o >= 0 ? base + o + c * 8 : base;
    cp_async16(dst + sw128_offset(r, c, rows), src, o >= 0 ? 16 : 0);
  }
}

constexpr int kKeys = 64;           // keys per K/V tile

// Key tile k0 .. k0 + 63 of (batch b, kv head hk) of k, v [B, Sk, nkv, D]:
// the K and V rows into the SW128 tiles at kdst and vdst, each key's
// valid flag into kok[64].  A key past Sk or masked out by the [B, Sk]
// mask (null: none) is zeros and flag 0, and is never read.
template <int D, int NTHREADS, class T>
__device__ __forceinline__ void load_kv_tile(
    uint32_t kdst, uint32_t vdst, int* kok, const T* k, const T* v,
    const int* mask, int b, int Sk, int nkv, int hk, int k0) {
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
// Wait until at most N committed wgmma groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
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

// BODY(type string) for the 16-bit operand type T: "bf16" or "f16".
#define PTT_WGMMA_TYPED(T, BODY)                                           \
  static_assert(std::is_same<T, __nv_bfloat16>::value ||                   \
                    std::is_same<T, __half>::value,                        \
                "wgmma operands are bf16 or fp16");                        \
  if constexpr (std::is_same<T, __half>::value) {                          \
    BODY("f16");                                                           \
  } else {                                                                 \
    BODY("bf16");                                                          \
  }

// d (+)= A B for a 64 x 64 x 16 step, A and B K-major in shared memory,
// both of type T.  accumulate 0 overwrites d.
#define PTT_SS(TY)                                                         \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY    \
               " " PTT_D32_LIST ", %32, %33, p, 1, 1, 0, 0;\n}\n"         \
               : PTT_D32(d)                                                \
               : "l"(da), "l"(db), "r"(accumulate))
template <class T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  PTT_WGMMA_TYPED(T, PTT_SS)
}
#undef PTT_SS

// d += A B for a 64 x 64 x 16 step, A the register fragment a[4] (pairs
// of T), B MN-major in shared memory (the transpose bit set).
#define PTT_RS_T(TY)                                                       \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY    \
               " " PTT_D32_LIST ", {%32, %33, %34, %35}, %36, p, 1, 1, "    \
               "1;\n}\n"                                                  \
               : PTT_D32(d)                                                \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),      \
                 "r"(1))
template <class T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_t(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  PTT_WGMMA_TYPED(T, PTT_RS_T)
}
#undef PTT_RS_T

#define PTT_D64(d)                                                         \
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),            \
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),            \
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),       \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),       \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),       \
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),       \
      "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),       \
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),       \
      "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),       \
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),       \
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),       \
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define PTT_D64_LIST                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "       \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "        \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "        \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "        \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define PTT_D128(d)                                                        \
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),            \
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),            \
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),       \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),       \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),       \
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),       \
      "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),       \
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),       \
      "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),       \
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),       \
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),       \
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),       \
      "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),       \
      "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),       \
      "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),       \
      "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),       \
      "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),       \
      "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),       \
      "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),       \
      "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),                \
      "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),                \
      "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),                \
      "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),                \
      "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),                \
      "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),                \
      "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
#define PTT_D128_LIST                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "       \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "        \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "        \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "        \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "        \
  "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "        \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "        \
  "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "        \
  "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "       \
  "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "       \
  "%127}"

// d (+)= A B for a 64 x N x 16 step (N 64, 128 or 256), A the register
// fragment a[4] (pairs of T, acc_to_a's layout), B K-major in shared
// memory (an SW128 tile of N rows, as wgmma_ss reads it); accumulate 0
// overwrites d.  The accumulator extends the n64 layout below to N / 8
// column blocks of 8.  weight_only_gemm.cu's products: A the dequantized
// weight codes, B the rows of x.
#define PTT_RS64(TY)                                                       \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY    \
               " " PTT_D32_LIST ", {%32, %33, %34, %35}, %36, p, 1, 1, "    \
               "0;\n}\n"                                                  \
               : PTT_D32(d)                                                \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),      \
                 "r"(accumulate))
#define PTT_RS128(TY)                                                      \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY   \
               " " PTT_D64_LIST ", {%64, %65, %66, %67}, %68, p, 1, 1, "    \
               "0;\n}\n"                                                  \
               : PTT_D64(d)                                                \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),      \
                 "r"(accumulate))
#define PTT_RS256(TY)                                                      \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"               \
               "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY   \
               " " PTT_D128_LIST ", {%128, %129, %130, %131}, %132, p, 1, " \
               "1, 0;\n}\n"                                               \
               : PTT_D128(d)                                               \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),      \
                 "r"(accumulate))
template <class T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  PTT_WGMMA_TYPED(T, PTT_RS64)
}

template <class T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  PTT_WGMMA_TYPED(T, PTT_RS128)
}

template <class T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  PTT_WGMMA_TYPED(T, PTT_RS256)
}
#undef PTT_RS64
#undef PTT_RS128
#undef PTT_RS256
#undef PTT_WGMMA_TYPED

#undef PTT_D32
#undef PTT_D64
#undef PTT_D128
#undef PTT_D32_LIST
#undef PTT_D64_LIST
#undef PTT_D128_LIST

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

// Two floats rounded to the 16-bit type T (round to nearest even), as the
// pair a register of a wgmma A fragment holds.
template <class T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    __half2 v = __float22half2_rn(make_float2(lo, hi));
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    return pack_bf16(lo, hi);
  }
}

// The two values of a register of pairs of T, as floats.
template <class T>
__device__ __forceinline__ float2 unpack2(uint32_t u) {
  if constexpr (std::is_same<T, __half>::value)
    return __half22float2(*reinterpret_cast<const __half2*>(&u));
  else
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// The A fragment of k-step kk (columns 16 kk .. 16 kk + 15) of a 64 x 64
// accumulator, rounded to T: registers {row g, cols 2t..}, {row g + 8},
// {row g, cols 8 + 2t..}, {row g + 8, cols 8 + 2t..} -- exactly the
// accumulator's d[8kk .. 8kk + 7] in pairs.
template <class T = __nv_bfloat16>
__device__ __forceinline__ void acc_to_a(const float (&d)[32], int kk,
                                         uint32_t (&a)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
    a[r] = pack2<T>(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}

// Rows g and g + 8 of a warp's share of a 64 x (64 NB) accumulator
// (column block nb in acc[nb]), times scale[r], as T (bf16 or fp16) into
// the rows row[r] < Sq of out [B, Sq, nh, W] at batch b, head h, columns
// col0 .. col0 + 64 NB - 1; lane t of the row's four writes 2 columns of
// each 8.
template <int NB, int W = 64 * NB, class T>
__device__ __forceinline__ void store_rows(T* out,
                                           const float (&acc)[NB][32],
                                           const int (&row)[2],
                                           const float (&scale)[2], int Sq,
                                           int b, int nh, int h, int t,
                                           int col0 = 0) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= Sq) continue;
    T* dst = out + ((b * (long long)Sq + row[r]) * nh + h) * W + col0;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + nb * 64 + j * 8 + 2 * t) =
            pack2<T>(acc[nb][4 * j + 2 * r] * scale[r],
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

// mbarriers (64-bit words in shared memory, by shared address).  A
// barrier completes a phase when its arrivals reach the count given at
// init and the bytes announced by expect_tx have landed; waiters name the
// phase by its parity.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// After the inits, before any other thread or the TMA unit uses them.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// One arrival that also announces `bytes` of TMA writes to come.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
// Wait until the phase of parity `parity` has completed.  A wait that
// never ends (a parity out of step: a bug) traps after 2^26 polls, so a
// fault surfaces as a launch error instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// TMA: the box at (c0 innermost, c1) of the tensor map `map` (a kernel
// parameter, __grid_constant__) into shared memory at `dst`, completing
// on the mbarrier `bar`; elements outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_prefetch_map(const void* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// Move registers between the warpgroups of a warp-specialised block:
// every warp of a warpgroup executes the same one.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

}  // namespace tc
}  // namespace ptt
