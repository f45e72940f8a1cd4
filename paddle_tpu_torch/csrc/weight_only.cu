// Weight-only quantized matrix product for Hopper (sm_90a): the serving
// tick's linear layers over int8 or fp8 (e4m3) weight codes.
//
// It does not replace a Pallas kernel.  The JAX package dequantizes the
// weight snapshot inside every compiled serving program
// (paddle_tpu/inference/quant.py `dequant_values`, driven by
// `_bind_params` in inference/serving.py) and relies on XLA to fuse the
// per-channel scale multiply into the consuming dot
// (paddle_tpu/quantization/weight_only.py:90 `dequantize`).  PyTorch fuses
// nothing: `dequantize(q, s)` then a matmul reads 1 byte a weight, writes 2
// and reads 2 again, more traffic than the bf16 weight it was meant to
// halve.  This kernel is the fused product:
//
//   y[m, n] = sum_k x[m, k] * W[n, k]  (+ bias[n])
//   W[n, k] = round_to_x_type(float(q[n, k]) * float(s[n]))
//
// q [N, K] int8 or float8_e4m3fn codes (the nn.Linear layout: an output
// channel's K codes contiguous), s [N] and bias [N] in x's type, x [M, K]
// and y [M, N] bfloat16 or float32, 1 <= M <= 128, K a multiple of 16.
// Rounding each dequantized weight to x's type before the product is the
// plain version's arithmetic (`dequantize(q, s)`, then the matmul); every
// sum is float32.
//
// What bounds it: at the tick's few rows (decode M = the batch, the
// speculative verify M = batch x (k + 1)) each weight byte feeds 2 M
// operations, far below the ~590 operations a byte at which the tensor
// cores become the limit, so bytes: the codes, read once.  Llama-2 7B's
// gate_proj (N 11008, K 4096) at M 8 reads 45.1 MB: 0.0135 ms at
// 3.35 TB/s; a whole decode step's linear layers ~6.6 GB, ~1.97 ms.
//
// Design, simple and right first:
// * bfloat16: a block of 8 warps owns a slab of 32 output channels (4
//   tiles of 8; 16 channels where N is too narrow to give every SM two
//   blocks); its warps split K, warp w taking the 64-code chunks
//   w, w + 8, ...  A lane loads 16 codes of each of its channels in one
//   16-byte load (streamed past L1), the next chunk's codes in flight
//   while it works on this one (at M <= 16, the decode tick's rows: codes
//   two chunks ahead and x one chunk ahead), dequantizes them in
//   registers (int8 by the 2^23 magic-number trick, fp8 by the hardware's
//   e4m3 -> f16x2 conversion) and multiplies on the tensor cores with
//   mma.sync.m16n8k16 (bf16 in, fp32 sums) over M / 16 row tiles.  The
//   product does not care in which order k is summed, so a lane's 16
//   contiguous codes feed its four B-fragment pairs and the A fragments
//   read the same 16 contiguous x values (one 32-byte load a row): no
//   shuffle.  x is read through L1 and L2 (the 8 warps of a block read
//   disjoint chunks, so shared memory would share nothing).  The 8 warps'
//   partial sums meet in shared memory and are added in warp order:
//   deterministic, no atomics.
// * float32 (the precision reference of the card-against-CPU checks): one
//   warp per output channel and block of 8 rows, FMAs, a warp-shuffle sum.
// Not yet: wgmma, TMA, split-K across blocks for narrow N (N 2048 gives 64
// blocks for 132 SMs), tensor cores sized for M up to 128.  Products of
// more than 128 bf16 rows (the prompts) run weight_only_gemm.cu.
#include <cuda_runtime.h>

#include "weight_only_common.cuh"

namespace ptt {

constexpr int kWoWarps = 8;       // warps of a bf16 block, splitting K
constexpr int kWoSlab = 32;       // output channels of a wide bf16 block
constexpr int kWoChunk = 64;      // codes of a channel per warp step
constexpr int kWoMaxM = 128;
constexpr int kWoFmaWarps = 4;    // fp32: channels per block
constexpr int kWoFmaRows = 8;     // fp32: rows per warp

// 16-byte load that does not allocate in L1: the codes are read once.
__device__ __forceinline__ uint4 wo_load_stream(const uint8_t* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ void wo_mma(float* c, uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 16 bf16 of one x row from column k as 8 packed pairs (zeros off the
// matrix).
__device__ __forceinline__ void wo_load_x(const __nv_bfloat16* x, int row,
                                          int k, int M, int K, bool kok,
                                          uint32_t* a) {
  if (row < M && kok) {
    const uint4* p =
        reinterpret_cast<const uint4*>(x + (size_t)row * K + k);
    const uint4 u = __ldg(p), v = __ldg(p + 1);
    a[0] = u.x; a[1] = u.y; a[2] = u.z; a[3] = u.w;
    a[4] = v.x; a[5] = v.y; a[6] = v.z; a[7] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = 0u;
  }
}

// bf16: one block of 8 warps per slab of 8 NT output channels (NT tiles
// of 8); MT tiles of 16 rows (M <= 16 MT).  Lane (g, t) = (lane / 4,
// lane % 4) holds channel n0 + 8 j + g of tile j and, per chunk, its
// codes k0 + 16 t .. + 15; the mma's logical k (2t, 2t+1 | 2t+8, 2t+9) of
// step s is physical k0 + 16 t + 4 s + (0, 1 | 2, 3), for A and B alike.
template <int QT, int MT, int NT>
__global__ void __launch_bounds__(kWoWarps * 32, MT <= 2 ? 2 : 1)
    weight_only_mma_kernel(const __nv_bfloat16* __restrict__ x,
                           const uint8_t* __restrict__ q,
                           const __nv_bfloat16* __restrict__ scale,
                           const __nv_bfloat16* __restrict__ bias,
                           __nv_bfloat16* __restrict__ y, int M, int N,
                           int K) {
  __shared__ __align__(16) float red[kWoWarps][32][4 * NT];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * 8 * NT;
  float sc[NT];
  bool nok[NT];
  const uint8_t* qrow[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = n0 + 8 * j + g;
    nok[j] = n < N;
    sc[j] = nok[j] ? __bfloat162float(scale[n]) : 0.f;
    qrow[j] = q + (size_t)(nok[j] ? n : 0) * K;
  }
  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  const int nchunks = (K + kWoChunk - 1) / kWoChunk;
  uint4 cur[NT], nxt[NT];
  auto load_codes = [&](int c, uint4* dst) {
    const int k = c * kWoChunk + 16 * t;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      dst[j] = (nok[j] && c < nchunks && k < K) ? wo_load_stream(qrow[j] + k)
                                                 : make_uint4(0, 0, 0, 0);
  };
  auto load_xs = [&](int c, int i, uint32_t* a0, uint32_t* a1) {
    const int k = c * kWoChunk + 16 * t;
    const bool kok = c < nchunks && k < K;
    wo_load_x(x, 16 * i + g, k, M, K, kok, a0);
    wo_load_x(x, 16 * i + g + 8, k, M, K, kok, a1);
  };
  load_codes(warp, cur);
  if constexpr (MT == 1) {
    // the decode tick's rows: codes two chunks ahead and x one chunk ahead
    // in flight, each tile's codes dequantized just before its mma
    uint4 far[NT];
    uint32_t a0[8], a1[8];
    load_codes(warp + kWoWarps, nxt);
    load_xs(warp, 0, a0, a1);
    for (int c = warp; c < nchunks; c += kWoWarps) {
      load_codes(c + 2 * kWoWarps, far);
      uint32_t xn0[8], xn1[8];
      load_xs(c + kWoWarps, 0, xn0, xn1);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t b[8];
        wo_dequant_bf16<QT>(cur[j], sc[j], b);
#pragma unroll
        for (int s = 0; s < 4; ++s)
          wo_mma(acc[0][j], a0[2 * s], a1[2 * s], a0[2 * s + 1],
                 a1[2 * s + 1], b[2 * s], b[2 * s + 1]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        cur[j] = nxt[j];
        nxt[j] = far[j];
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        a0[e] = xn0[e];
        a1[e] = xn1[e];
      }
    }
  } else {
    for (int c = warp; c < nchunks; c += kWoWarps) {
      load_codes(c + kWoWarps, nxt);
      uint32_t b[NT][8];
#pragma unroll
      for (int j = 0; j < NT; ++j) wo_dequant_bf16<QT>(cur[j], sc[j], b[j]);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        uint32_t a0[8], a1[8];
        load_xs(c, i, a0, a1);
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int j = 0; j < NT; ++j)
            wo_mma(acc[i][j], a0[2 * s], a1[2 * s], a0[2 * s + 1],
                   a1[2 * s + 1], b[j][2 * s], b[j][2 * s + 1]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) cur[j] = nxt[j];
    }
  }

  // the warps' partial sums, row tile by row tile, added in warp order
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    float4* mine = reinterpret_cast<float4*>(red[warp][lane]);
#pragma unroll
    for (int j = 0; j < NT; ++j)
      mine[j] = make_float4(acc[i][j][0], acc[i][j][1], acc[i][j][2],
                            acc[i][j][3]);
    __syncthreads();
    for (int o = threadIdx.x; o < 32 * 4 * NT; o += kWoWarps * 32) {
      const int l = o / (4 * NT), v = o % (4 * NT);
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWoWarps; ++w) sum += red[w][l][v];
      // accumulator v = 4 j + r: row g (+ 8 for r >= 2), column 2 t + r % 2
      const int j = v >> 2, r = v & 3;
      const int row = 16 * i + (l >> 2) + (r >> 1) * 8;
      const int col = n0 + 8 * j + 2 * (l & 3) + (r & 1);
      if (row < M && col < N) {
        if (bias != nullptr) sum += __bfloat162float(bias[col]);
        y[(size_t)row * N + col] = __float2bfloat16_rn(sum);
      }
    }
    __syncthreads();
  }
}

// 16 codes -> 16 float32 weights float(code) * s.
template <int QT>
__device__ __forceinline__ void wo_dequant_f32(const uint4& c, float s,
                                               float* w) {
  const uint32_t u[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    wo_codes4<QT>(u[i], w + 4 * i);
#pragma unroll
    for (int e = 0; e < 4; ++e) w[4 * i + e] = __fmul_rn(w[4 * i + e], s);
  }
}

// float32: warp w of block b computes channel 4 b + w for rows
// 8 blockIdx.y .. + 7; each lane takes 16 codes of every 512.
template <int QT>
__global__ void __launch_bounds__(kWoFmaWarps * 32)
    weight_only_fma_kernel(const float* __restrict__ x,
                           const uint8_t* __restrict__ q,
                           const float* __restrict__ scale,
                           const float* __restrict__ bias,
                           float* __restrict__ y, int M, int N, int K) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWoFmaWarps + warp;
  const int m0 = blockIdx.y * kWoFmaRows;
  if (n >= N) return;              // the whole warp: no block barrier here
  const float s = scale[n];
  const uint8_t* qr = q + (size_t)n * K;
  float acc[kWoFmaRows];
#pragma unroll
  for (int r = 0; r < kWoFmaRows; ++r) acc[r] = 0.f;
  for (int k = 16 * lane; k < K; k += 32 * 16) {
    float w[16];
    wo_dequant_f32<QT>(*reinterpret_cast<const uint4*>(qr + k), s, w);
#pragma unroll
    for (int r = 0; r < kWoFmaRows; ++r) {
      const int m = m0 + r;
      if (m >= M) break;
      const float4* xr =
          reinterpret_cast<const float4*>(x + (size_t)m * K + k);
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const float4 xv = __ldg(xr + v);
        acc[r] = fmaf(w[4 * v], xv.x, acc[r]);
        acc[r] = fmaf(w[4 * v + 1], xv.y, acc[r]);
        acc[r] = fmaf(w[4 * v + 2], xv.z, acc[r]);
        acc[r] = fmaf(w[4 * v + 3], xv.w, acc[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kWoFmaRows; ++r) {
    float a = acc[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      a += __shfl_xor_sync(0xffffffffu, a, off);
    const int m = m0 + r;
    if (lane == 0 && m < M)
      y[(size_t)m * N + n] = bias != nullptr ? a + bias[n] : a;
  }
}

// The slab: 32 channels, or 16 where 32-channel slabs would not give
// every SM two blocks (N 4096: 128 blocks of 32 leave each SM 8 warps).
template <int QT, int MT>
void wo_launch_mma(const void* x, const void* q, const void* s,
                   const void* bias, void* y, int M, int N, int K,
                   cudaStream_t st) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* qp = static_cast<const uint8_t*>(q);
  const auto* sp = static_cast<const __nv_bfloat16*>(s);
  const auto* bp = static_cast<const __nv_bfloat16*>(bias);
  auto* yp = static_cast<__nv_bfloat16*>(y);
  if ((N + kWoSlab - 1) / kWoSlab < 2 * sms)
    weight_only_mma_kernel<QT, MT, 2>
        <<<(N + 15) / 16, kWoWarps * 32, 0, st>>>(xp, qp, sp, bp, yp, M, N,
                                                  K);
  else
    weight_only_mma_kernel<QT, MT, 4>
        <<<(N + 31) / 32, kWoWarps * 32, 0, st>>>(xp, qp, sp, bp, yp, M, N,
                                                  K);
}

template <int QT>
void wo_launch_bf16(const void* x, const void* q, const void* s,
                    const void* bias, void* y, int M, int N, int K,
                    cudaStream_t st) {
  switch ((M + 15) / 16) {
    case 1: wo_launch_mma<QT, 1>(x, q, s, bias, y, M, N, K, st); break;
    case 2: wo_launch_mma<QT, 2>(x, q, s, bias, y, M, N, K, st); break;
    case 3: wo_launch_mma<QT, 3>(x, q, s, bias, y, M, N, K, st); break;
    case 4: wo_launch_mma<QT, 4>(x, q, s, bias, y, M, N, K, st); break;
    case 5: wo_launch_mma<QT, 5>(x, q, s, bias, y, M, N, K, st); break;
    case 6: wo_launch_mma<QT, 6>(x, q, s, bias, y, M, N, K, st); break;
    case 7: wo_launch_mma<QT, 7>(x, q, s, bias, y, M, N, K, st); break;
    default: wo_launch_mma<QT, 8>(x, q, s, bias, y, M, N, K, st); break;
  }
}

template <int QT>
void wo_launch_f32(const void* x, const void* q, const void* s,
                   const void* bias, void* y, int M, int N, int K,
                   cudaStream_t st) {
  const dim3 grid((N + kWoFmaWarps - 1) / kWoFmaWarps,
                  (M + kWoFmaRows - 1) / kWoFmaRows);
  weight_only_fma_kernel<QT><<<grid, kWoFmaWarps * 32, 0, st>>>(
      static_cast<const float*>(x), static_cast<const uint8_t*>(q),
      static_cast<const float*>(s), static_cast<const float*>(bias),
      static_cast<float*>(y), M, N, K);
}

}  // namespace ptt

// x [M, K], q [N, K] codes, scale [N], bias [N] or null, y [M, N]; all
// contiguous on the device, x 16-byte aligned, 1 <= M <= 128, N >= 1, K a
// positive multiple of 16.  dtype (x, scale, bias, y): 0 = float32,
// 1 = bfloat16; qtype: 0 = int8, 1 = float8_e4m3fn.  Returns the launch's
// cudaError_t.
extern "C" int ptt_weight_only_matmul(const void* x, const void* q,
                                      const void* scale, const void* bias,
                                      void* y, int M, int N, int K,
                                      int dtype, int qtype, void* stream) {
  if (M < 1 || M > ptt::kWoMaxM || N < 1 || K < 16 || K % 16 ||
      (dtype != 0 && dtype != 1) || (qtype != 0 && qtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (qtype == 0)
      ptt::wo_launch_bf16<0>(x, q, scale, bias, y, M, N, K, st);
    else
      ptt::wo_launch_bf16<1>(x, q, scale, bias, y, M, N, K, st);
  } else {
    if (qtype == 0)
      ptt::wo_launch_f32<0>(x, q, scale, bias, y, M, N, K, st);
    else
      ptt::wo_launch_f32<1>(x, q, scale, bias, y, M, N, K, st);
  }
  return (int)cudaGetLastError();
}
