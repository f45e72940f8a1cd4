// Single-token decode attention over the paged KV pool for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_decode_kernel` in
// paddle_tpu/ops/pallas_paged.py (driven by `paged_attention`): every
// decode step of the serving engine, once per layer.
//
// Computes, for one query token per sequence q [B, nh, hd] against the
// pools [nh, num_blocks, bs, hd] read through the block table
// [B, max_blocks] and the lengths seq_lens [B]:
//   out[b, h] = softmax over positions < seq_lens[b] of q k^T / sqrt(hd) . v
// Only positions below min(len, max_blocks * bs) are read, so never a
// column past the table, and a key whose table entry lies outside the pool
// is dropped (as paged_chunk.cu and the plain versions drop it).  A row
// with len 0 reads nothing and writes zeros
// (the TPU kernel's l == 0 guard): the engine's free slots run through the
// tick that way.
//
// What bounds it: one query row against len keys is ~4 len hd flops on
// ~2 len hd pool elements, about 1 flop per byte in bf16 — far below the
// H100's ~295, so memory bounds it: the live K and V rows must stream once
// from device memory at 3.35 TB/s, and the kernel is as fast as the bytes
// it keeps in flight.
//
// Layout on the card: one block of 8 warps per (head, sequence); the TPU
// kernel's sequential walk over pool blocks becomes 8 independent walks.
// The block first copies its table row into shared memory, so no key's
// address waits on a global load.  Warp w takes the groups of U
// consecutive key positions w, w + 8, ...; each lane owns hd / 32
// neighbouring columns, so one vector load per lane reads a whole key row
// coalesced.  The loop is software-pipelined: the K and V rows of the
// warp's next U keys are loaded into registers before the current U are
// used.  The U dot products are summed with warp shuffles, and each warp
// keeps its own online-softmax state (m, l and its columns of the output)
// in registers.  No barrier runs inside the loop; at the end the 8 partial
// states merge through shared memory by their maxima.
//
// What it does not do yet: one block per (head, sequence) keeps the time
// tied to the longest sequence, which a single block streams far below the
// card's rate.  Splitting a long row over several blocks (a second pass
// merging their partial softmax states) is the next step.
#include "attention_common.cuh"

namespace ptt {

constexpr int kDecodeWarps = 8;
constexpr int kDecodeThreads = 32 * kDecodeWarps;

// One lane's VEC neighbouring elements of a key or value row, kept as the
// raw 32-bit words they were loaded as (half the registers of fp32 for
// bf16) until they are used.
template <typename T, int VEC>
struct Frag {
  static constexpr int W = VEC * (int)sizeof(T) / 4;
  uint32_t w[W];

  __device__ __forceinline__ void load(const T* p) {
    const uint32_t* src = reinterpret_cast<const uint32_t*>(p);
    if constexpr (W % 4 == 0) {
#pragma unroll
      for (int i = 0; i < W; i += 4) {
        uint4 v = *reinterpret_cast<const uint4*>(src + i);
        w[i] = v.x; w[i + 1] = v.y; w[i + 2] = v.z; w[i + 3] = v.w;
      }
    } else if constexpr (W == 2) {
      uint2 v = *reinterpret_cast<const uint2*>(src);
      w[0] = v.x; w[1] = v.y;
    } else {
      w[0] = src[0];
    }
  }

  __device__ __forceinline__ void to_float(float* f) const {
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int i = 0; i < W; ++i) f[i] = __uint_as_float(w[i]);
    } else {
#pragma unroll
      for (int i = 0; i < W; ++i) {
        float2 v = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
        f[2 * i] = v.x; f[2 * i + 1] = v.y;
      }
    }
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kDecodeThreads)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                        const T* __restrict__ v_pool,
                        const int* __restrict__ tables,
                        const int* __restrict__ seq_lens, T* __restrict__ out,
                        int nh, int num_blocks, int bs, int max_blocks,
                        float scale) {
  constexpr int VEC = D / 32;                     // columns per lane
  using F = Frag<T, VEC>;
  // keys per warp step: ~32 words of K+V in flight per lane and buffer
  constexpr int U = 32 / (2 * F::W) < 2 ? 2
                    : 32 / (2 * F::W) > 8 ? 8 : 32 / (2 * F::W);
  constexpr int kStride = kDecodeWarps * U;
  __shared__ float m_w[kDecodeWarps], l_w[kDecodeWarps];
  __shared__ float acc_w[kDecodeWarps][D];
  extern __shared__ int table[];   // this sequence's table row
  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = lane * VEC;

  float qv[VEC];
  {
    F qf;
    qf.load(q + ((long long)b * nh + h) * D + col);
    qf.to_float(qv);
  }
  const int len = min(seq_lens[b], max_blocks * bs);
  for (int i = threadIdx.x; i < max_blocks; i += kDecodeThreads)
    table[i] = tables[(long long)b * max_blocks + i];
  __syncthreads();
  const long long head_base = (long long)h * num_blocks;

  // issue the loads of the U keys at base..base+U-1 (none past len)
  F kf[U], vf[U];
  bool live[U];
  auto fetch = [&](int base) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = base + u;
      const int blk = p < len ? table[p / bs] : -1;
      live[u] = blk >= 0 && blk < num_blocks;  // else dropped, never read
      if (live[u]) {
        const long long off = ((head_base + blk) * bs + p % bs) * D + col;
        kf[u].load(k_pool + off);
        vf[u].load(v_pool + off);
      }
    }
  };

  float m = kMaskedInit, l = 0.f, acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;

  fetch(warp * U);
  for (int base = warp * U; base < len; base += kStride) {
    // take this step's rows, then start the next step's loads before
    // any of this step's arithmetic, so they overlap it
    F kc[U], vc[U];
    bool lc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      kc[u] = kf[u];
      vc[u] = vf[u];
      lc[u] = live[u];
    }
    fetch(base + kStride);

    float s[U];
    float mx = -INFINITY;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float part = 0.f;
      if (lc[u]) {
        float kr[VEC];
        kc[u].to_float(kr);
#pragma unroll
        for (int i = 0; i < VEC; ++i) part = fmaf(qv[i], kr[i], part);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      s[u] = lc[u] ? part * scale : -INFINITY;
      mx = fmaxf(mx, s[u]);
    }
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] *= alpha;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!lc[u]) continue;
      const float p = expf(s[u] - m_new);
      float vr[VEC];
      vc[u].to_float(vr);
      l += p;
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = fmaf(p, vr[i], acc[i]);
    }
    m = m_new;
  }

  // merge the warps' partial softmax states
  if (lane == 0) {
    m_w[warp] = m;
    l_w[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc_w[warp][col + i] = acc[i];
  __syncthreads();
  float mall = kMaskedInit;
#pragma unroll
  for (int w = 0; w < kDecodeWarps; ++w) mall = fmaxf(mall, m_w[w]);
  float lall = 0.f;
  float wgt[kDecodeWarps];
#pragma unroll
  for (int w = 0; w < kDecodeWarps; ++w) {
    wgt[w] = expf(m_w[w] - mall);
    lall += wgt[w] * l_w[w];
  }
  const float inv = 1.f / (lall == 0.f ? 1.f : lall);
  T* orow = out + ((long long)b * nh + h) * D;
  for (int d = threadIdx.x; d < D; d += kDecodeThreads) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) o = fmaf(wgt[w], acc_w[w][d], o);
    orow[d] = from_float<T>(o * inv);
  }
}

template <typename T, int D>
cudaError_t launch_decode(const void* q, const void* k_pool,
                          const void* v_pool, const int* tables,
                          const int* seq_lens, void* out, int B, int nh,
                          int num_blocks, int bs, int max_blocks,
                          cudaStream_t stream) {
  // the table row: with the static arrays (at most 8.3 KB) under the 48 KB
  // a launch may take without opting in, for any table up to 8192 blocks
  // (the wrapper refuses more)
  const size_t smem = (size_t)max_blocks * sizeof(int);
  dim3 grid(nh, B);
  paged_decode_kernel<T, D><<<grid, kDecodeThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), tables, seq_lens, static_cast<T*>(out),
      nh, num_blocks, bs, max_blocks, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_decode(int hd, const void* q, const void* k_pool,
                            const void* v_pool, const int* tables,
                            const int* seq_lens, void* out, int B, int nh,
                            int num_blocks, int bs, int max_blocks,
                            cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch_decode<T, 64>(q, k_pool, v_pool, tables, seq_lens, out,
                                  B, nh, num_blocks, bs, max_blocks, stream);
    case 128:
      return launch_decode<T, 128>(q, k_pool, v_pool, tables, seq_lens, out,
                                   B, nh, num_blocks, bs, max_blocks, stream);
    case 256:
      return launch_decode<T, 256>(q, k_pool, v_pool, tables, seq_lens, out,
                                   B, nh, num_blocks, bs, max_blocks, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace ptt

// q [B, nh, hd], pools [nh, num_blocks, bs, hd], tables [B, max_blocks]
// int32, seq_lens [B] int32, out like q; all contiguous on the device.
// hd in 64/128/256.  dtype: 0 = float32, 1 = bfloat16.  Returns the
// launch's cudaError_t.
extern "C" int ptt_paged_decode(const void* q, const void* k_pool,
                                const void* v_pool, const void* tables,
                                const void* seq_lens, void* out, int B,
                                int nh, int hd, int num_blocks, int bs,
                                int max_blocks, int dtype, void* stream) {
  if (B <= 0 || nh <= 0 || bs <= 0 || max_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tables);
  const int* lens = static_cast<const int*>(seq_lens);
  cudaError_t err =
      dtype == 1 ? ptt::dispatch_decode<__nv_bfloat16>(
                       hd, q, k_pool, v_pool, t, lens, out, B, nh,
                       num_blocks, bs, max_blocks, st)
      : dtype == 0 ? ptt::dispatch_decode<float>(hd, q, k_pool, v_pool, t,
                                                 lens, out, B, nh, num_blocks,
                                                 bs, max_blocks, st)
                   : cudaErrorInvalidValue;
  return (int)err;
}
