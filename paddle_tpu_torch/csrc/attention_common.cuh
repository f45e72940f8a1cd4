// Pieces shared by the attention kernels: type conversion, 4-wide loads,
// the dropout keep bits, and the 64x64 online-softmax tile loop that
// flash_fwd.cu and paged_chunk.cu both run.  The two kernels differ only
// in where a key row lives (a dense [B, S, nkv, hd] tensor or a block of
// the paged pool) and in the mask, which they pass in as small device
// lambdas.
//
// Numerics follow the JAX package's kernels: fp32 accumulation, scores
// scaled by 1/sqrt(hd), the running max starts at -1e30 (not -inf), and a
// row that saw no valid key ends with l == 0 and writes zeros.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ptt {

constexpr float kMaskedInit = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Four consecutive elements as fp32; p must be 4-element aligned.
__device__ __forceinline__ void load4(const float* p, float* f) {
  float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* f) {
  uint2 u = *reinterpret_cast<const uint2*>(p);
  float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u.x));
  float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u.y));
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
}

// ---------------------------------------------------------------------------
// Dropout (flash_fwd, flash_bwd).  The keep bit of score (row, col) of one
// (batch, head) is a pure function of the seed and the ABSOLUTE query row
// and key column, so the forward and both backward kernels redraw the same
// bits whatever their tiling: the lowbias32 mix of the JAX package's
// _hash_bits (paddle_tpu/ops/pallas_flash.py:116) with the seed word
// seed ^ (bh << 20), kept when the bits are below thresh =
// uint32((1 - rate) * 4294967295).  ops/flash_attention.py draws the same
// bits in its plain versions.
// ---------------------------------------------------------------------------
struct Dropout {
  unsigned word = 0;     // seed ^ (bh << 20)
  unsigned thresh = 0;   // keep when bits < thresh
  float keep_p = 1.f;    // 1 - rate: a kept p is divided by it
  int row0 = 0;          // absolute query row of the tile's row 0
  bool on = false;
};

__host__ __device__ __forceinline__ unsigned dropout_word(unsigned seed,
                                                         int bh) {
  return seed ^ ((unsigned)bh << 20);
}

__device__ __forceinline__ bool dropout_keep(unsigned word, unsigned thresh,
                                             int row, int col) {
  unsigned x = (unsigned)row * 0x00010193u + (unsigned)col +
               word * 0x9E3779B9u;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x < thresh;
}

// ---------------------------------------------------------------------------
// 64 x 64 tile machinery (flash_fwd, paged_chunk)
// ---------------------------------------------------------------------------
constexpr int kTile = 64;      // query rows per block and keys per step
constexpr int kThreads = 256;  // a 16 x 16 grid of threads

// Everything a block keeps in shared memory.  Rows of q and k are padded
// by one float so that the 16 threads of a half-warp, which read 16
// different rows at the same column, hit 16 different banks.
template <int D>
struct TileSmem {
  float q[kTile][D + 1];
  float k[kTile][D + 1];
  float v[kTile][D];
  float s[kTile][kTile + 1];
  float m[kTile], l[kTile], alpha[kTile];
  long long qoff[kTile];  // element offset of each query row, -1 = none
  long long koff[kTile];  // element offset of each key row, -1 = none
};

// Stage R rows of D elements as fp32; a row whose offset is -1 is zeros.
template <typename T, int D, int LD, int R = kTile>
__device__ __forceinline__ void load_rows(float (*dst)[LD],
                                          const T* __restrict__ base,
                                          const long long* off) {
  constexpr int C4 = D / 4;
  for (int idx = threadIdx.x; idx < R * C4; idx += kThreads) {
    const int r = idx / C4, c = (idx % C4) * 4;
    float f[4] = {0.f, 0.f, 0.f, 0.f};
    const long long o = off[r];
    if (o >= 0) load4(base + o + c, f);
    dst[r][c] = f[0];
    dst[r][c + 1] = f[1];
    dst[r][c + 2] = f[2];
    dst[r][c + 3] = f[3];
  }
}

// Set up the block's query rows: qoff[r] must be filled by the caller for
// r < 64 (threads 0..63) before the call.  Starts the softmax state.
template <typename T, int D>
__device__ __forceinline__ void init_tile(TileSmem<D>& sm,
                                          const T* __restrict__ q) {
  if (threadIdx.x < kTile) {
    sm.m[threadIdx.x] = kMaskedInit;
    sm.l[threadIdx.x] = 0.f;
  }
  __syncthreads();
  load_rows<T, D, D + 1>(sm.q, q, sm.qoff);
}

// The online-softmax loop over keys 0 .. k_end-1 in steps of 64.
// key_off(kpos) gives a key's element offset in k/v, or -1 for a key that
// is not there (masked like one past k_end); valid(r, kpos) says whether
// query row r may see key kpos.  Thread (ty, tx) owns score
// and output rows ty + 16 i, and output columns tx + 16 j.  With
// drop.on, l sums the undropped p while acc sums the dropped, rescaled p.
template <typename T, int D, class KeyOff, class Valid>
__device__ __forceinline__ void attend_tile(TileSmem<D>& sm,
                                            const T* __restrict__ k,
                                            const T* __restrict__ v,
                                            int k_end, float scale,
                                            KeyOff key_off, Valid valid,
                                            float (&acc)[4][D / 16],
                                            const Dropout drop = Dropout()) {
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int row = tid / 4, sub = tid % 4;  // softmax: 4 threads per row
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    if (tid < kTile) {
      const int kp = k0 + tid;
      sm.koff[tid] = kp < k_end ? key_off(kp) : -1;
    }
    __syncthreads();
    load_rows<T, D, D + 1>(sm.k, k, sm.koff);
    load_rows<T, D, D>(sm.v, v, sm.koff);
    __syncthreads();

    // S = Q K^T for this thread's 4 x 4 scores
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sm.q[ty + 16 * i][d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sm.k[tx + 16 * j][d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j, kp = k0 + c;
        // -inf for a masked key: exp(-inf - m) is 0 even while m is
        // still the -1e30 start, so a fully masked row keeps l == 0
        sm.s[r][c] = (sm.koff[c] >= 0 && valid(r, kp)) ? s[i][j] * scale
                                                       : -INFINITY;
      }
    __syncthreads();

    // online softmax, one row per 4 neighbouring threads of a warp
    float mx = -INFINITY;
    for (int c = sub; c < kTile; c += 4) mx = fmaxf(mx, sm.s[row][c]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_prev = sm.m[row];
    const float m_new = fmaxf(m_prev, mx);
    float sum = 0.f;
    for (int c = sub; c < kTile; c += 4) {
      const float p = expf(sm.s[row][c] - m_new);
      sum += p;
      sm.s[row][c] =
          !drop.on ? p
          : dropout_keep(drop.word, drop.thresh, drop.row0 + row, k0 + c)
              ? p / drop.keep_p
              : 0.f;
    }
    // the shuffles also order the four lanes' reads of m/l before the
    // write below
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (sub == 0) {
      const float a = expf(m_prev - m_new);
      sm.alpha[row] = a;
      sm.l[row] = sm.l[row] * a + sum;
      sm.m[row] = m_new;
    }
    __syncthreads();

    // O = alpha O + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = sm.alpha[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] *= a;
    }
#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float p[4], vv[D / 16];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sm.s[ty + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) vv[j] = sm.v[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < D / 16; ++j)
          acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// out = acc / l (l == 0 -> zeros); lse = m + log(l) when lse is given,
// indexed by query row within the tile.  Rows with qoff == -1 are ragged
// padding and are not written.
template <typename T, int D>
__device__ __forceinline__ void finish_tile(TileSmem<D>& sm,
                                            T* __restrict__ out,
                                            float* __restrict__ lse,
                                            const float (&acc)[4][D / 16]) {
  __syncthreads();
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const long long o = sm.qoff[r];
    if (o < 0) continue;
    const float l = sm.l[r];
    const float l_safe = l == 0.f ? 1.f : l;
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      out[o + tx + 16 * j] = from_float<T>(acc[i][j] / l_safe);
  }
  if (lse != nullptr && tid < kTile && sm.qoff[tid] >= 0) {
    const float l = sm.l[tid];
    lse[tid] = sm.m[tid] + logf(l == 0.f ? 1.f : l);
  }
}

template <int D>
constexpr size_t tile_smem_bytes() {
  return sizeof(TileSmem<D>);
}

// Let `kernel` take `bytes` of dynamic shared memory (past the 48 KB
// default).  Callers keep the result in a function-local static, so the
// driver call runs once per kernel instantiation, not once per launch; the
// attribute then holds for the card the process drives.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace ptt
