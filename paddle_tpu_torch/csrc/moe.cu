// Token routing of the mixture-of-experts layer for Hopper (sm_90a): the
// fused dispatch and combine of the GPT-MoE blocks.
//
// Replaces the Pallas TPU kernels `_dispatch_kernel` and `_combine_kernel`
// in paddle_tpu/ops/pallas_moe.py (driven by `moe_dispatch` and
// `moe_combine`): every MoE block runs one of each per forward.
//
// moe_dispatch packs token rows into the flat expert buffers:
//   out[i, :] = x[inv[i], :]    for inv[i] in [0, T)
//   out[i, :] = 0               for inv[i] == T (an empty capacity slot)
// x [T, M], inv [E*C] int32, out [E*C, M].  An empty slot writes zeros and
// reads nothing, so no zero row is appended to x (the TPU kernel pads x
// with one, a full copy of the activations).  The kernel moves bytes and
// never looks at them: float32 and bfloat16 take the same code.
//
// moe_combine mixes the experts' output rows back to the tokens:
//   out[t, :] = sum_j w[t, j] * rows[flat[t, j], :]   (j = 0 .. k-1)
// rows [E*C, M] float32 or bfloat16, w [T, k] float32, flat [T, k] int32,
// out [T, M] in the rows' type.  A choice whose slot is the dummy E*C
// (dropped past capacity) contributes 0 and reads nothing.  Each product
// is rounded to float32, then added in j order to a float32 sum, as the
// TPU kernel does (`term = w * row; acc = acc + term`); __fmul_rn and
// __fadd_rn keep nvcc from contracting the pair into one FMA, so the
// float32 kernel equals the plain version bit for bit.  The sum is
// rounded once to the output type.
//
// What bounds them: no arithmetic to speak of, so bytes.  Dispatch reads
// each filled slot's row once and writes every slot's row; combine reads
// each kept choice's row and writes one row per token.  At the training
// shape (T 8192, M 2048, E 4, C 2458, float32) that is at most 2 x 9832 x
// 2048 x 4 B = 161 MB for dispatch and 3 x 8192 x 2048 x 4 B = 201 MB for
// combine: 0.048 and 0.060 ms at 3.35 TB/s.
//
// Layout on the card: one block of up to 128 threads per output row (a
// slot for dispatch, a token for combine); each thread moves 16-byte
// vectors (4 float32 or 8 bfloat16), neighbouring threads on neighbouring
// addresses, so every row moves in whole coalesced lines.  The TPU
// kernels' single grid step with a sequential loop over rows becomes one
// block per row, all independent; combine's block reads its token's k
// slots and weights into shared memory once.  No TMA: a row gather has
// no tile to stage.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ptt {

constexpr int kMoeThreads = 128;
constexpr int kMoeMaxK = 8;

__device__ __forceinline__ void unpack16(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack16(const uint4& u, float* f,
                                         __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    float2 p = __bfloat1622float2(h);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 pack16(const float* f, float) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}

__device__ __forceinline__ uint4 pack16(const float* f, __nv_bfloat16) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// One block per output row; nvec 16-byte vectors per row.
__global__ void __launch_bounds__(kMoeThreads)
    moe_dispatch_kernel(const uint4* __restrict__ x,
                        const int* __restrict__ inv, uint4* __restrict__ out,
                        int T, int nvec) {
  const int row = blockIdx.x;
  const int src = __ldg(inv + row);
  uint4* dst = out + (size_t)row * nvec;
  if (src < 0 || src >= T) {          // an empty slot: zeros, no read
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    for (int v = threadIdx.x; v < nvec; v += blockDim.x) dst[v] = z;
    return;
  }
  const uint4* s = x + (size_t)src * nvec;
#pragma unroll 4
  for (int v = threadIdx.x; v < nvec; v += blockDim.x) dst[v] = __ldg(s + v);
}

// One block per token; nvec 16-byte vectors of VEC elements per row.
template <typename T>
__global__ void __launch_bounds__(kMoeThreads)
    moe_combine_kernel(const uint4* __restrict__ rows,
                       const float* __restrict__ w,
                       const int* __restrict__ flat, uint4* __restrict__ out,
                       int EC, int k, int nvec) {
  constexpr int VEC = 16 / (int)sizeof(T);
  __shared__ int s_slot[kMoeMaxK];
  __shared__ float s_w[kMoeMaxK];
  const int t = blockIdx.x;
  if (threadIdx.x < k) {
    s_slot[threadIdx.x] = __ldg(flat + (size_t)t * k + threadIdx.x);
    s_w[threadIdx.x] = __ldg(w + (size_t)t * k + threadIdx.x);
  }
  __syncthreads();
  for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    for (int j = 0; j < k; ++j) {
      const int slot = s_slot[j];
      if (slot < 0 || slot >= EC) continue;   // the dummy slot: adds 0
      const float wj = s_w[j];
      float val[VEC];
      unpack16(__ldg(rows + (size_t)slot * nvec + v), val, T());
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        acc[i] = __fadd_rn(acc[i], __fmul_rn(wj, val[i]));
    }
    out[(size_t)t * nvec + v] = pack16(acc, T());
  }
}

inline int row_threads(int nvec) {
  return nvec >= kMoeThreads ? kMoeThreads : ((nvec + 31) / 32) * 32;
}

inline int elem_bytes(int dtype) {
  return dtype == 0 ? 4 : dtype == 1 ? 2 : 0;
}

}  // namespace ptt

// x [T, M], inv [rows] int32, out [rows, M]; all contiguous on the device,
// 16-byte aligned, M * element size a multiple of 16.  dtype: 0 = float32,
// 1 = bfloat16.  Returns the launch's cudaError_t.
extern "C" int ptt_moe_dispatch(const void* x, const void* inv, void* out,
                                int T, int rows, int M, int dtype,
                                void* stream) {
  const int eb = ptt::elem_bytes(dtype);
  if (eb == 0 || T < 0 || rows <= 0 || M <= 0 || (M * eb) % 16)
    return (int)cudaErrorInvalidValue;
  const int nvec = M * eb / 16;
  ptt::moe_dispatch_kernel<<<rows, ptt::row_threads(nvec), 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<const int*>(inv),
      static_cast<uint4*>(out), T, nvec);
  return (int)cudaGetLastError();
}

// rows [EC, M], w [T, k] float32, flat [T, k] int32, out [T, M] like rows;
// all contiguous on the device, rows and out 16-byte aligned, M * element
// size a multiple of 16, 1 <= k <= 8.  dtype: 0 = float32, 1 = bfloat16.
// Returns the launch's cudaError_t.
extern "C" int ptt_moe_combine(const void* rows, const void* w,
                               const void* flat, void* out, int T, int EC,
                               int k, int M, int dtype, void* stream) {
  const int eb = ptt::elem_bytes(dtype);
  if (eb == 0 || T <= 0 || EC < 0 || k < 1 || k > ptt::kMoeMaxK || M <= 0 ||
      (M * eb) % 16)
    return (int)cudaErrorInvalidValue;
  const int nvec = M * eb / 16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint4* r = static_cast<const uint4*>(rows);
  const float* wt = static_cast<const float*>(w);
  const int* f = static_cast<const int*>(flat);
  uint4* o = static_cast<uint4*>(out);
  const int threads = ptt::row_threads(nvec);   // >= 32 >= k
  if (dtype == 0)
    ptt::moe_combine_kernel<float><<<T, threads, 0, st>>>(r, wt, f, o, EC, k,
                                                          nvec);
  else
    ptt::moe_combine_kernel<__nv_bfloat16><<<T, threads, 0, st>>>(
        r, wt, f, o, EC, k, nvec);
  return (int)cudaGetLastError();
}
