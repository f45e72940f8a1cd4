// Weight-only quantized matrix product for wide products on Hopper
// (sm_90a): the serving engine's prompt programs (pad buckets above 128
// rows, 256-token chunks) over int8 or fp8 (e4m3) weight codes.
//
// It does not replace a Pallas kernel.  The JAX package dequantizes the
// weight snapshot inside every compiled serving program and XLA fuses the
// per-channel scale multiply into the consuming dot
// (paddle_tpu/quantization/weight_only.py:90 `dequantize`), at any row
// count.  weight_only.cu is that fused product for the tick's few rows;
// this kernel is it for the prompts:
//
//   y[m, n] = sum_k x[m, k] * W[n, k]  (+ bias[n])
//   W[n, k] = bf16(float(q[n, k]) * float(s[n]))
//
// q [N, K] int8 or float8_e4m3fn codes (the nn.Linear layout), s [N] and
// bias [N] bf16, x [M, K] and y [M, N] bf16, any M >= 1 and N >= 1 (edges
// zero-filled), K a multiple of 16; sums in fp32.  Every weight is rounded
// to bf16 by weight_only_common.cuh's wo_dequant_bf16, as the decode
// kernel rounds it: a prompt and a decode tick multiply by the same bf16
// weights, the plain version's (`dequantize(q, s)`, then the product).
//
// What bounds it: arithmetic.  Each weight byte feeds 2 M operations;
// at M 256 that is ~512 a code byte, past the ~295 a byte at which the
// H100's bf16 tensor cores become the limit.  Llama-2 7B's gate_proj at a
// 2048-row prompt is 184.7 GFLOP: 0.187 ms at 989 TFLOP/s.
//
// Design, simple and right first (tc_common.cuh's pieces):
// * A block of two warpgroups owns a 128 x BN tile of y (BN 128, or 64
//   where 128-wide tiles would leave SMs without a block: a 256-token
//   chunk at N 4096 gives 64 tiles of 128 x 128 for 132 SMs); warpgroup w
//   owns its 64 rows and issues m64nBNk16 wgmma (tc::wgmma_ss) with A and
//   B from shared memory, fp32 accumulators in registers.
// * K goes in steps of 64.  Each step's x tile (128 x 64 bf16, each
//   warpgroup copying its own 64 rows) and code tile (BN x 64 bytes) come
//   in by 16-byte cp.async into a three-stage ring, two steps ahead.  The
//   codes are dequantized by the block's 256 threads (a thread owns
//   BN / 64 chunks of 16 codes: its channels' scales stay in registers)
//   into a bf16 SW128 tile of W, double-buffered: a row [n][k] of W is
//   K-major like a key tile in S = Q K^T.  Then fence.proxy.async, a
//   barrier, and the step's four k16 products, left in flight: step t's
//   products run while step t + 1's codes are dequantized, and the block
//   waits for step t - 1's only before its x stage is copied over.
// * The epilogue adds the bias to the fp32 sums and rounds them to bf16.
// It runs at ~420 TFLOP/s at a 2048-row prompt (PERF.md).  Measured and
// not kept: 128 x 256 tiles (one block per SM: slower everywhere), and
// the transposed product y^T = W x^T with the dequantized codes as
// wgmma's register A operand (no bf16 W in shared memory): at best equal
// over a 2048-row prompt's products, slower at 256 and 512 rows.
// Not yet: TMA, a producer warpgroup (the dequantize and the products
// share the warps; two blocks per SM overlap one another's), persistent
// blocks, fp8 codes on the fp8 tensor cores.
#include <cuda_runtime.h>

#include "tc_common.cuh"
#include "weight_only_common.cuh"

namespace ptt {

constexpr int kWgRows = 128;      // rows of y per block: two warpgroups
constexpr int kWgK = 64;          // k per step: one SW128 row of bf16
constexpr int kWgStages = 3;      // x and code tiles in the ring
constexpr int kWgThreads = 256;

// Shared memory of weight_only_gemm_kernel, bytes from the 1024-aligned
// base: three x stages [128][64] and two W tiles [BN][64] (SW128), then
// three code stages [BN][64] (plain, 64 bytes a channel).
template <int BN>
struct WgSmem {
  static constexpr int x_stage = kWgRows * tc::kRowBytes;
  static constexpr int w_stage = BN * tc::kRowBytes;
  static constexpr int c_stage = BN * kWgK;
  static constexpr int x = 0;
  static constexpr int w = x + kWgStages * x_stage;
  static constexpr int codes = w + 2 * w_stage;
  static constexpr int bytes = codes + kWgStages * c_stage + tc::kGroupBytes;
};

template <int QT, int BN>
__global__ void __launch_bounds__(kWgThreads, 2)
    weight_only_gemm_kernel(const __nv_bfloat16* __restrict__ x,
                            const uint8_t* __restrict__ q,
                            const __nv_bfloat16* __restrict__ scale,
                            const __nv_bfloat16* __restrict__ bias,
                            __nv_bfloat16* __restrict__ y, int M, int N,
                            int K) {
  using S = WgSmem<BN>;
  constexpr int CPT = BN / 64;    // 16-code chunks a thread copies per step
  extern __shared__ __align__(16) unsigned char wg_smem[];
  unsigned char* base = tc::align1024(wg_smem);
  const uint32_t sbase = tc::smem_addr(base);
  const int tid = threadIdx.x, wg = tid >> 7, lt = tid & 127;
  const int m0 = blockIdx.x * kWgRows, n0 = blockIdx.y * BN;
  const int nk = (K + kWgK - 1) / kWgK;

  // this thread's code chunks: channel n0 + tid / 4 + 64 i, codes
  // 16 (tid % 4) .. + 15 of each step
  const int cc = tid & 3;
  float sc[CPT];
  bool nok[CPT];
  const uint8_t* qrow[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int n = n0 + (tid >> 2) + 64 * i;
    nok[i] = n < N;
    sc[i] = nok[i] ? __bfloat162float(scale[n]) : 0.f;
    qrow[i] = q + (size_t)(nok[i] ? n : 0) * K + 16 * cc;
  }

  // step kt's x rows of this warpgroup and the block's codes into stage
  // kt % kWgStages; off the matrix: zeros
  auto load = [&](int kt) {
    const int st = kt % kWgStages, k0 = kt * kWgK;
    const uint32_t xs = sbase + S::x + st * S::x_stage;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = lt + 128 * i;
      const int r = wg * 64 + (idx >> 3), c = idx & 7;
      const int m = m0 + r, k = k0 + 8 * c;
      const bool ok = m < M && k < K;
      tc::cp_async16(xs + tc::sw128_offset(r, c, kWgRows),
                     ok ? x + (size_t)m * K + k : x, ok ? 16 : 0);
    }
    const uint32_t cs = sbase + S::codes + st * S::c_stage;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int n = (tid >> 2) + 64 * i;
      const bool ok = nok[i] && k0 + 16 * cc < K;
      tc::cp_async16(cs + n * kWgK + 16 * cc, ok ? qrow[i] + k0 : q,
                     ok ? 16 : 0);
    }
  };

  // the first product overwrites the sums (no zeroing instruction may
  // define them while products are in flight: ptxas would serialize)
  float acc[BN / 2];
#pragma unroll
  for (int s = 0; s < kWgStages - 1; ++s) {
    if (s < nk) load(s);
    tc::cp_async_commit();
  }
  const uint32_t xa = sbase + S::x + wg * 64 * tc::kRowBytes;

  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % kWgStages, wb = kt & 1;
    tc::cp_async_wait<kWgStages - 2>();
    // step kt's tiles landed; every warpgroup is done with step kt - 2's
    // products, the last reader of W tile wb
    __syncthreads();
    const unsigned char* cs = base + S::codes + st * S::c_stage;
    unsigned char* ws = base + S::w + wb * S::w_stage;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int n = (tid >> 2) + 64 * i;
      const uint4 c =
          *reinterpret_cast<const uint4*>(cs + n * kWgK + 16 * cc);
      uint32_t b[8];
      wo_dequant_bf16<QT>(c, sc[i], b);
      *reinterpret_cast<uint4*>(ws + tc::sw128_offset(n, 2 * cc, BN)) =
          make_uint4(b[0], b[1], b[2], b[3]);
      *reinterpret_cast<uint4*>(ws + tc::sw128_offset(n, 2 * cc + 1, BN)) =
          make_uint4(b[4], b[5], b[6], b[7]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // W tile wb written, visible to wgmma

    const uint32_t xd = xa + st * S::x_stage;
    const uint32_t wd = sbase + S::w + wb * S::w_stage;
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgK / 16; ++kk) {
      const int accumulate = kt > 0 || kk > 0;
      tc::wgmma_ss(acc, tc::desc(xd + kk * 32), tc::desc(wd + kk * 32),
                   accumulate);
    }
    tc::wgmma_commit();
    // step kt - 1's products done: its x stage, (kt + 2) % 3, is free
    tc::wgmma_wait<1>();
    if (kt + kWgStages - 1 < nk) load(kt + kWgStages - 1);
    tc::cp_async_commit();
  }
  tc::wgmma_wait<0>();
  tc::fence_regs(acc);

  // accumulator 4 j + 2 r + e: row g + 8 r of this warp's 16, column
  // 8 j + 2 t + e
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = m0 + wg * 64 + warp * 16 + g + 8 * r;
    if (m >= M) continue;
    __nv_bfloat16* yr = y + (size_t)m * N;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * t;
      if (n >= N) continue;
      float v0 = acc[4 * j + 2 * r], v1 = acc[4 * j + 2 * r + 1];
      const bool two = n + 1 < N;
      if (bias != nullptr) {
        v0 += __bfloat162float(bias[n]);
        if (two) v1 += __bfloat162float(bias[n + 1]);
      }
      if (two && (N & 1) == 0) {
        *reinterpret_cast<uint32_t*>(yr + n) = tc::pack_bf16(v0, v1);
      } else {
        yr[n] = __float2bfloat16_rn(v0);
        if (two) yr[n + 1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

template <int QT, int BN>
cudaError_t wg_launch(const void* x, const void* q, const void* s,
                      const void* bias, void* y, int M, int N, int K,
                      cudaStream_t st) {
  const size_t smem = WgSmem<BN>::bytes;
  auto kernel = weight_only_gemm_kernel<QT, BN>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((M + kWgRows - 1) / kWgRows, (N + BN - 1) / BN);
  kernel<<<grid, kWgThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q),
      static_cast<const __nv_bfloat16*>(s),
      static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(y), M, N, K);
  return cudaGetLastError();
}

// BN 128 unless its tiles would number fewer than the SMs; a constant of
// the shape, so a captured launch replays the same kernel
template <int QT>
cudaError_t wg_dispatch(const void* x, const void* q, const void* s,
                        const void* bias, void* y, int M, int N, int K,
                        cudaStream_t st) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const long long tiles =
      (long long)((M + kWgRows - 1) / kWgRows) * ((N + 127) / 128);
  return tiles >= sms ? wg_launch<QT, 128>(x, q, s, bias, y, M, N, K, st)
                      : wg_launch<QT, 64>(x, q, s, bias, y, M, N, K, st);
}

}  // namespace ptt

// x [M, K] bf16, q [N, K] codes, scale [N] bf16, bias [N] bf16 or null,
// y [M, N] bf16; all contiguous on the device, x and q 16-byte aligned,
// M >= 1, N >= 1, K a positive multiple of 16.  qtype: 0 = int8,
// 1 = float8_e4m3fn.  Returns the launch's cudaError_t.
extern "C" int ptt_weight_only_gemm(const void* x, const void* q,
                                    const void* scale, const void* bias,
                                    void* y, int M, int N, int K, int qtype,
                                    void* stream) {
  if (M < 1 || N < 1 || K < 16 || K % 16 || (qtype != 0 && qtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      qtype == 0 ? ptt::wg_dispatch<0>(x, q, scale, bias, y, M, N, K, st)
                 : ptt::wg_dispatch<1>(x, q, scale, bias, y, M, N, K, st);
  return (int)err;
}
