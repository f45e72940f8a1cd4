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
// bias [N] bf16, x [M, K] and y [M, N] bf16, any M >= 1 and N >= 1, K a
// multiple of 16; sums in fp32, the bias added to the fp32 sum, one
// rounding to bf16.  Every weight is rounded by weight_only_common.cuh
// (wo_pair_bf16, wo_dequant_bf16's rounding), as the decode kernel rounds
// it: a prompt and a decode tick multiply by the same bf16 weights, the
// plain version's (`dequantize(q, s)`, then the product).
//
// What bounds it: arithmetic, then shared memory.  Each weight byte feeds
// 2 M operations; at M 256 that is ~512 a code byte, past the ~295 a byte
// at which the H100's bf16 tensor cores become the limit (Llama-2 7B's
// gate_proj at a 2048-row prompt: 184.7 GFLOP, 0.187 ms at 989 TFLOP/s).
// At that rate an SM's tensor cores finish a 64-deep step of a 128 x 256
// tile (4.2 MFLOP) in ~1024 clocks, and shared memory moves 128 bytes a
// clock.  The design before this one (bf16 W dequantized into shared
// memory, both operands read from there) moved ~0.047 bytes a FLOP
// there: ~190 a clock, a ceiling at ~2/3 of the tensor rate before
// anything else, and it also spent the product warps' time on cp.async
// addresses, two block barriers a step and the dequantize.
//
// Design (warp-specialised, one persistent block per SM):
// * The transposed product y^T = W x^T.  A (64 channels x k16) is the
//   dequantized weight in registers, built by the consumer threads
//   straight from the code tile into wgmma's A fragments; B is up to 256
//   rows of x, K-major as x lies in memory.  No bf16 W ever reaches
//   shared memory.  Per 64-deep step of a 128-channel x 256-row tile,
//   shared memory takes the x tile (32 KB) and the code tile (8 KB) from
//   TMA, the two consumer warpgroups' products read the x tile (64 KB)
//   and the fragment gathers read the codes (8 KB in 32-bit words, half
//   a wavefront's width): ~120 bytes a clock at the full tensor rate.
// * A block is 384 threads: one producer warpgroup (setmaxnreg down to
//   40 registers) whose one thread issues the TMA loads of the x tile
//   (128-byte swizzle: tc_common.cuh's SW128, read by the products) and
//   of the code tile (64-byte swizzle: a warp's gathers from 8 channels'
//   rows fall in 8 bank groups) into a ring of stages guarded by full
//   and empty mbarriers; and two consumer warpgroups (setmaxnreg up to
//   232) of 64 channels each.  A consumer step: wait on the stage's full
//   barrier, gather and dequantize the step's four k16 fragments (each
//   thread 16 32-bit words, two codes of each), issue four m64nBMk16
//   wgmma with the fragments in registers, commit, and wait for the step
//   before, whose stage it then releases (one arrival per warp).
//   Fragments alternate between two register sets, so a step's
//   dequantize runs while the step before it is on the tensor cores.  No
//   __syncthreads and no cp.async in the loop; TMA fills rows, channels
//   and the K tail outside the matrices with zeros.
// * The schedule is a constant of (M, N, K, SM count), decided by the
//   wrapper (ops/weight_only.py gemm_schedule): BM x rows a tile (256,
//   128 or 64), the K splits and the blocks.  Blocks walk the units
//   (tile, split) in steps of the grid, rows of x fastest, so the blocks
//   running together share a code tile in L2.  Split units store fp32
//   partials in a workspace [splits, M, N] that weight_only_gemm_reduce_
//   kernel sums in split order before the bias: the same bits on every
//   launch and under graph replay, no atomics.
// * The epilogue stores each accumulator straight to y (bias added in
//   fp32, one bf16 rounding) or to the workspace, while the producer is
//   already loading the next unit's first stages.
// * The TMA descriptors are encoded on the host at every launch
//   (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint: no
//   -lcuda) and passed as __grid_constant__ parameters, so a captured
//   launch replays with its capture's tensors.
// Measured (PERF.md §6, an H100 80GB HBM3 at 700 W): 600-730 TFLOP/s
// at a 2048-row prompt, 1.1-1.25x torch.matmul on the bf16 weight.  With
// the conversion taken out (a diagnostic build multiplying raw code
// bits) a prompt's products took 9% less: the gathers cost nothing
// measurable, and the rest runs at ~80% of the bf16 peak where the tiles
// fill whole waves.  Loading half of each x tile (a diagnostic) saved 5%:
// L2 traffic is not what bounds it, so clusters multicasting the x tile
// would gain little.  Measured and not kept: 16-byte gathers of a whole
// code chunk (7% slower), waiting for each step's products before the
// next dequantize (3% slower).
#include <cuda.h>
#include <cuda_runtime.h>

#include "tc_common.cuh"
#include "weight_only_common.cuh"

namespace ptt {

constexpr int kWgChannels = 128;   // channels a tile: two warpgroups of 64
constexpr int kWgK = 64;           // k a step: one SW128 row of x
constexpr int kWgThreads = 384;    // producer + two consumer warpgroups
constexpr int kWgCodeStage = kWgChannels * kWgK;   // bytes of a code tile

// Shared memory of weight_only_gemm_kernel<., BM>, bytes from the
// 1024-aligned base: the x stages [BM][64] bf16 (SW128), the code stages
// [128][64] (SW64), then the full and the empty mbarriers.
template <int BM>
struct WgSmem {
  static constexpr int stages = BM == 256 ? 5 : 8;
  static constexpr int x_stage = BM * tc::kRowBytes;
  static constexpr int x = 0;
  static constexpr int codes = x + stages * x_stage;
  static constexpr int full = codes + stages * kWgCodeStage;
  static constexpr int empty = full + 8 * stages;
  static constexpr int bytes = empty + 8 * stages + tc::kGroupBytes;
  static constexpr uint32_t tx = x_stage + kWgCodeStage;   // bytes a stage
};

// Unit u of the schedule: x rows m0 .. m0 + BM - 1, channels n0 .. n0 +
// 127, k steps kb .. ke - 1, split index; rows of x fastest, then
// channels, then splits (tests/test_torch_quant.py walks the same).
struct WgUnit {
  int m0, n0, kb, ke, split;
};
template <int BM>
__device__ __forceinline__ WgUnit wg_unit(int u, int m_tiles, int n_tiles,
                                          int k_steps, int nk) {
  const int mt = u % m_tiles, rest = u / m_tiles;
  WgUnit w;
  w.m0 = mt * BM;
  w.n0 = (rest % n_tiles) * kWgChannels;
  w.split = rest / n_tiles;
  w.kb = w.split * k_steps;
  w.ke = min(nk, w.kb + k_steps);
  return w;
}

template <int QT, int BM>
__global__ void __launch_bounds__(kWgThreads, 1)
    weight_only_gemm_kernel(const __grid_constant__ CUtensorMap xmap,
                            const __grid_constant__ CUtensorMap qmap,
                            const __nv_bfloat16* __restrict__ scale,
                            const __nv_bfloat16* __restrict__ bias,
                            __nv_bfloat16* __restrict__ y,
                            float* __restrict__ ws, int M, int N, int K,
                            int m_tiles, int n_tiles, int splits,
                            int k_steps) {
  using S = WgSmem<BM>;
  extern __shared__ __align__(16) unsigned char wg_smem[];
  const uint32_t sbase = tc::smem_addr(tc::align1024(wg_smem));
  const int tid = threadIdx.x;
  const int nk = (K + kWgK - 1) / kWgK;
  const int units = m_tiles * n_tiles * splits;
  if (tid == 0) {
    for (int s = 0; s < S::stages; ++s) {
      tc::mbar_init(sbase + S::full + 8 * s, 1);
      tc::mbar_init(sbase + S::empty + 8 * s, 8);   // a consumer warp each
    }
    tc::mbar_init_fence();
  }
  __syncthreads();

  if (tid < 128) {
    // producer warpgroup: one thread keeps the ring full
    tc::setmaxnreg_dec<40>();
    if (tid == 0) {
      tc::tma_prefetch_map(&xmap);
      tc::tma_prefetch_map(&qmap);
      int st = 0;
      uint32_t ph = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const WgUnit w = wg_unit<BM>(u, m_tiles, n_tiles, k_steps, nk);
        for (int kt = w.kb; kt < w.ke; ++kt) {
          const uint32_t full = sbase + S::full + 8 * st;
          tc::mbar_wait(sbase + S::empty + 8 * st, ph ^ 1);
          tc::mbar_arrive_expect_tx(full, S::tx);
          tc::tma_load_2d(sbase + S::x + st * S::x_stage, &xmap, kt * kWgK,
                          w.m0, full);
          tc::tma_load_2d(sbase + S::codes + st * kWgCodeStage, &qmap,
                          kt * kWgK, w.n0, full);
          if (++st == S::stages) {
            st = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumer warpgroups: warpgroup wg owns channels 64 wg .. 64 wg + 63
  // of the tile, A rows g and g + 8 of warp `warp` are the code rows r0,
  // r0 + 8
  tc::setmaxnreg_inc<232>();
  const int ct = tid - 128, wg = ct >> 7, warp = (ct >> 5) & 3;
  const int lane = ct & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 64 * wg + 16 * warp + g;
  // byte offset in a code stage of the word holding codes 16 kk + 2t,
  // 2t + 1 of row r0 + 8 r (SW64: chunk kk of row r at kk ^ (r / 2 % 4));
  // codes 16 kk + 2t + 8, + 9 are 8 bytes on, in the same chunk
  uint32_t co[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      co[r][kk] = row * kWgK + ((kk ^ ((row >> 1) & 3)) << 4) + 4 * (t >> 1);
  }
  const int h = 2 * (t & 1);   // the pair's first byte in its word

  float acc[BM / 2];
  uint32_t a0[4][4], a1[4][4];
  int st = 0, prev = -1;
  uint32_t ph = 0;
  float s0 = 0.f, s1 = 0.f;

  // one 64-deep step into fragment set a; `first` overwrites the sums
  auto step = [&](uint32_t (&a)[4][4], bool first) {
    tc::mbar_wait(sbase + S::full + 8 * st, ph);
    const uint32_t cs = sbase + S::codes + st * kWgCodeStage;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t word[2][2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        asm volatile("ld.shared.b32 %0, [%1];\n"
                     : "=r"(word[r][0]) : "r"(cs + co[r][kk]));
        asm volatile("ld.shared.b32 %0, [%1];\n"
                     : "=r"(word[r][1]) : "r"(cs + co[r][kk] + 8));
      }
      a[kk][0] = wo_pair_bf16<QT>(word[0][0], h, s0);
      a[kk][1] = wo_pair_bf16<QT>(word[1][0], h, s1);
      a[kk][2] = wo_pair_bf16<QT>(word[0][1], h, s0);
      a[kk][3] = wo_pair_bf16<QT>(word[1][1], h, s1);
    }
    const uint32_t xs = sbase + S::x + st * S::x_stage;
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      tc::wgmma_rs(acc, a[kk], tc::desc(xs + 32 * kk), !first || kk > 0);
    tc::wgmma_commit();
    // the step before is done: its stage is free
    tc::wgmma_wait<1>();
    if (prev >= 0 && lane == 0) tc::mbar_arrive(sbase + S::empty + 8 * prev);
    prev = st;
    if (++st == S::stages) {
      st = 0;
      ph ^= 1;
    }
  };

  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const WgUnit w = wg_unit<BM>(u, m_tiles, n_tiles, k_steps, nk);
    const int c0 = w.n0 + r0, c1 = c0 + 8;
    s0 = c0 < N ? __bfloat162float(scale[c0]) : 0.f;
    s1 = c1 < N ? __bfloat162float(scale[c1]) : 0.f;
    // pairs of steps, then an odd one: on every path the set a step
    // writes was last read by products already waited for
    const int n = w.ke - w.kb;
    int i = 0;
    for (; i + 1 < n; i += 2) {
      step(a0, i == 0);
      step(a1, false);
    }
    if (i < n) step(a0, i == 0);
    tc::wgmma_wait<0>();
    tc::fence_regs(acc);
    if (lane == 0) tc::mbar_arrive(sbase + S::empty + 8 * prev);
    prev = -1;

    // accumulator 4 j + 2 r + e: channel c0 + 8 r, x row m0 + 8 j + 2 t + e
    if (splits == 1) {
      const float b0 = bias != nullptr && c0 < N ? __bfloat162float(bias[c0])
                                                 : 0.f;
      const float b1 = bias != nullptr && c1 < N ? __bfloat162float(bias[c1])
                                                 : 0.f;
#pragma unroll
      for (int j = 0; j < BM / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = w.m0 + 8 * j + 2 * t + e;
          if (m >= M) continue;
          __nv_bfloat16* yr = y + (size_t)m * N;
          if (c0 < N) yr[c0] = __float2bfloat16_rn(acc[4 * j + e] + b0);
          if (c1 < N) yr[c1] = __float2bfloat16_rn(acc[4 * j + 2 + e] + b1);
        }
    } else {
      float* wr = ws + (size_t)w.split * M * N;
#pragma unroll
      for (int j = 0; j < BM / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = w.m0 + 8 * j + 2 * t + e;
          if (m >= M) continue;
          if (c0 < N) wr[(size_t)m * N + c0] = acc[4 * j + e];
          if (c1 < N) wr[(size_t)m * N + c1] = acc[4 * j + 2 + e];
        }
    }
  }
}

// y = bf16(sum over splits of ws[split] (in split order) + bias)
__global__ void weight_only_gemm_reduce_kernel(
    const float* __restrict__ ws, const __nv_bfloat16* __restrict__ bias,
    __nv_bfloat16* __restrict__ y, int M, int N, int splits) {
  const size_t total = (size_t)M * N;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = ws[i];
    for (int s = 1; s < splits; ++s) v += ws[s * total + i];
    if (bias != nullptr) v += __bfloat162float(bias[i % N]);
    y[i] = __float2bfloat16_rn(v);
  }
}

using TensorMapEncode = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime uses, or null
static TensorMapEncode wg_encoder() {
  static TensorMapEncode fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<TensorMapEncode>(p)
               : nullptr;
  }();
  return fn;
}

// A row-major [rows, inner] tensor read in boxes of box_rows x box_inner
static bool wg_map(CUtensorMap* map, CUtensorMapDataType type,
                   const void* ptr, int inner, int rows, size_t row_bytes,
                   int box_inner, int box_rows, CUtensorMapSwizzle swizzle) {
  const TensorMapEncode encode = wg_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int QT, int BM>
cudaError_t wg_launch(const void* x, const void* q, const void* s,
                      const void* bias, void* y, void* ws, int M, int N,
                      int K, int splits, int k_steps, int blocks,
                      cudaStream_t st) {
  CUtensorMap xmap, qmap;
  if (!wg_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M,
              (size_t)K * 2, kWgK, BM, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !wg_map(&qmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, K, N, (size_t)K, kWgK,
              kWgChannels, CU_TENSOR_MAP_SWIZZLE_64B))
    return cudaErrorInvalidValue;
  const size_t smem = WgSmem<BM>::bytes;
  auto kernel = weight_only_gemm_kernel<QT, BM>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  const int m_tiles = (M + BM - 1) / BM;
  const int n_tiles = (N + kWgChannels - 1) / kWgChannels;
  kernel<<<blocks, kWgThreads, smem, st>>>(
      xmap, qmap, static_cast<const __nv_bfloat16*>(s),
      static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(ws), M, N, K,
      m_tiles, n_tiles, splits, k_steps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t total = (size_t)M * N;
  const int threads = 256;
  const size_t want = (total + threads - 1) / threads;
  const int grid = want < 4096 ? (int)want : 4096;
  weight_only_gemm_reduce_kernel<<<grid, threads, 0, st>>>(
      static_cast<const float*>(ws), static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(y), M, N, splits);
  return cudaGetLastError();
}

template <int QT>
cudaError_t wg_dispatch(const void* x, const void* q, const void* s,
                        const void* bias, void* y, void* ws, int M, int N,
                        int K, int rows, int splits, int k_steps, int blocks,
                        cudaStream_t st) {
  switch (rows) {
    case 256:
      return wg_launch<QT, 256>(x, q, s, bias, y, ws, M, N, K, splits,
                                k_steps, blocks, st);
    case 128:
      return wg_launch<QT, 128>(x, q, s, bias, y, ws, M, N, K, splits,
                                k_steps, blocks, st);
    default:
      return wg_launch<QT, 64>(x, q, s, bias, y, ws, M, N, K, splits,
                               k_steps, blocks, st);
  }
}

}  // namespace ptt

// x [M, K] bf16, q [N, K] codes, scale [N] bf16, bias [N] bf16 or null,
// y [M, N] bf16; all contiguous on the device, x and q 16-byte aligned,
// M >= 1, N >= 1, K a positive multiple of 16.  qtype: 0 = int8,
// 1 = float8_e4m3fn.  The schedule (ops/weight_only.py gemm_schedule):
// `rows` x rows a tile (256, 128 or 64), `splits` K splits of `k_steps`
// 64-deep steps (every split non-empty), `blocks` persistent blocks; ws
// an fp32 workspace [splits, M, N] when splits > 1, else null.  Returns
// the launches' cudaError_t.
extern "C" int ptt_weight_only_gemm(const void* x, const void* q,
                                    const void* scale, const void* bias,
                                    void* y, void* ws, int M, int N, int K,
                                    int qtype, int rows, int splits,
                                    int k_steps, int blocks, void* stream) {
  const int nk = (K + ptt::kWgK - 1) / ptt::kWgK;
  if (M < 1 || N < 1 || K < 16 || K % 16 || (qtype != 0 && qtype != 1) ||
      (rows != 256 && rows != 128 && rows != 64) || splits < 1 ||
      k_steps < 1 || (long long)splits * k_steps < nk ||
      (long long)(splits - 1) * k_steps >= nk || blocks < 1 ||
      (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      qtype == 0 ? ptt::wg_dispatch<0>(x, q, scale, bias, y, ws, M, N, K,
                                       rows, splits, k_steps, blocks, st)
                 : ptt::wg_dispatch<1>(x, q, scale, bias, y, ws, M, N, K,
                                       rows, splits, k_steps, blocks, st);
  return (int)err;
}
