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
// it keeps in flight across the whole card.
//
// Layout on the card: two kernels.  The TPU kernel's sequential walk over
// a row's pool blocks is cut into splits of about 256 keys (a whole number
// of pool blocks; ops/paged_attention.py picks blocks_per_split from the
// table's width alone: the lengths live on the card, and reading them on
// the host would synchronise every layer of every decode step).
// - paged_decode_split_kernel: one block of 4 warps per (head, sequence,
//   split), so that several blocks sit on one SM and a long row is
//   streamed by many SMs at once, not by one.  A split at or past the
//   row's length writes the empty state (m = -inf, l = 0) and exits at
//   once.  Otherwise the block stages its slice of the table row in
//   shared memory (no key's address waits on a global load); warp w takes
//   the groups of U consecutive key positions w, w + 4, ...; each lane owns
//   hd / 32 neighbouring columns, so one vector load per lane reads a
//   whole key row coalesced; the loop is software-pipelined (the next U
//   keys' K and V rows are loaded into registers before the current U are
//   used); the U dot products are summed with warp shuffles, and each warp
//   keeps an online-softmax state (m, l, its columns of the output) in
//   registers.  The four warps' states merge through shared memory by
//   their maxima, and the split writes its partial state, unnormalised,
//   to the workspace [B, nh, n_split, hd + 2] fp32 (acc[hd], m, l).
// - paged_decode_merge_kernel: one block per (head, sequence) merges the
//   row's splits by their maxima, in split order (deterministic), skipping
//   empty ones: out = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s, and
//   zeros where no key was live (l == 0).

#include "attention_common.cuh"

namespace ptt {

constexpr int kDecodeWarps = 4;
constexpr int kDecodeThreads = 32 * kDecodeWarps;
// table entries one split stages, and splits one row may have (the
// wrapper keeps blocks_per_split and n_split within them)
constexpr int kMaxSplitBlocks = 256;
constexpr int kMaxSplits = 128;

// One lane's VEC neighbouring elements of a key or value row, kept as the
// raw 32-bit words they were loaded as (half the registers of fp32 for
// bf16 and fp16) until they are used.
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
    } else if constexpr (std::is_same<T, __half>::value) {
#pragma unroll
      for (int i = 0; i < W; ++i) {
        float2 v = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
        f[2 * i] = v.x; f[2 * i + 1] = v.y;
      }
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
    paged_decode_split_kernel(const T* __restrict__ q,
                              const T* __restrict__ k_pool,
                              const T* __restrict__ v_pool,
                              const int* __restrict__ tables,
                              const int* __restrict__ seq_lens,
                              float* __restrict__ work, int nh,
                              int num_blocks, int bs, int max_blocks,
                              int blocks_per_split, float scale) {
  constexpr int VEC = D / 32;                     // columns per lane
  using F = Frag<T, VEC>;
  // keys per warp step: ~32 words of K+V in flight per lane and buffer
  constexpr int U = 32 / (2 * F::W) < 2 ? 2
                    : 32 / (2 * F::W) > 8 ? 8 : 32 / (2 * F::W);
  constexpr int kStride = kDecodeWarps * U;
  __shared__ float m_w[kDecodeWarps], l_w[kDecodeWarps];
  __shared__ float acc_w[kDecodeWarps][D];
  __shared__ int table[kMaxSplitBlocks];   // this split's table entries
  const int h = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = lane * VEC;
  float* part = work + (((long long)b * nh + h) * gridDim.z + sp) * (D + 2);
  const int blk0 = sp * blocks_per_split;
  const int nblk = min(blocks_per_split, max_blocks - blk0);
  const int p0 = blk0 * bs;
  // this split's keys: p0 .. end - 1, never past the row or the table
  const int end = min(seq_lens[b], (blk0 + nblk) * bs);
  if (p0 >= end) {
    if (threadIdx.x == 0) {
      part[D] = -INFINITY;
      part[D + 1] = 0.f;
    }
    return;
  }

  float qv[VEC];
  {
    F qf;
    qf.load(q + ((long long)b * nh + h) * D + col);
    qf.to_float(qv);
  }
  for (int i = threadIdx.x; i < nblk; i += kDecodeThreads)
    table[i] = tables[(long long)b * max_blocks + blk0 + i];
  __syncthreads();
  const long long head_base = (long long)h * num_blocks;

  // issue the loads of the U keys at base..base+U-1 (none past end)
  F kf[U], vf[U];
  bool live[U];
  auto fetch = [&](int base) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = base + u;
      const int blk = p < end ? table[p / bs - blk0] : -1;
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

  fetch(p0 + warp * U);
  for (int base = p0 + warp * U; base < end; base += kStride) {
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
      float part_s = 0.f;
      if (lc[u]) {
        float kr[VEC];
        kc[u].to_float(kr);
#pragma unroll
        for (int i = 0; i < VEC; ++i) part_s = fmaf(qv[i], kr[i], part_s);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        part_s += __shfl_xor_sync(0xffffffffu, part_s, o);
      s[u] = lc[u] ? part_s * scale : -INFINITY;
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

  // merge the warps' states into the split's (m, l, acc), unnormalised;
  // a split whose keys were all dropped keeps m = -1e30, l = 0, acc = 0
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
  for (int d = threadIdx.x; d < D; d += kDecodeThreads) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) o = fmaf(wgt[w], acc_w[w][d], o);
    part[d] = o;
  }
  if (threadIdx.x == 0) {
    part[D] = mall;
    part[D + 1] = lall;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kDecodeThreads)
    paged_decode_merge_kernel(const float* __restrict__ work,
                              T* __restrict__ out, int nh, int n_split) {
  __shared__ float m_s[kMaxSplits], w_s[kMaxSplits], wl_s[kMaxSplits];
  const int h = blockIdx.x, b = blockIdx.y;
  const float* part = work + ((long long)b * nh + h) * n_split * (D + 2);
  const int s = threadIdx.x;               // n_split <= kDecodeThreads
  float m = -INFINITY, l = 0.f;
  if (s < n_split) {
    m = part[s * (D + 2) + D];
    l = part[s * (D + 2) + D + 1];
    m_s[s] = m;
  }
  __syncthreads();
  float mall = -INFINITY;
  for (int i = 0; i < n_split; ++i) mall = fmaxf(mall, m_s[i]);
  if (s < n_split) {
    // an empty split (m = -inf) weighs 0 and its acc is never read
    const float w = m == -INFINITY ? 0.f : expf(m - mall);
    w_s[s] = w;
    wl_s[s] = w * l;
  }
  __syncthreads();
  float lall = 0.f;
  for (int i = 0; i < n_split; ++i) lall += wl_s[i];
  T* orow = out + ((long long)b * nh + h) * D;
  for (int d = threadIdx.x; d < D; d += kDecodeThreads) {
    float o = 0.f;
    for (int i = 0; i < n_split; ++i)
      if (w_s[i] != 0.f) o = fmaf(w_s[i], part[i * (D + 2) + d], o);
    // lall == 0: a row with no key (zeros); a NaN score or value makes
    // lall or o NaN, and the row stays NaN, as in the plain version
    orow[d] = from_float<T>(lall != 0.f ? o / lall : 0.f);
  }
}

template <typename T, int D>
cudaError_t launch_decode(const void* q, const void* k_pool,
                          const void* v_pool, const int* tables,
                          const int* seq_lens, void* out, float* work, int B,
                          int nh, int num_blocks, int bs, int max_blocks,
                          int blocks_per_split, cudaStream_t stream) {
  const int n_split = (max_blocks + blocks_per_split - 1) / blocks_per_split;
  if (blocks_per_split > kMaxSplitBlocks || n_split > kMaxSplits)
    return cudaErrorInvalidValue;
  paged_decode_split_kernel<T, D>
      <<<dim3(nh, B, n_split), kDecodeThreads, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k_pool),
          static_cast<const T*>(v_pool), tables, seq_lens, work, nh,
          num_blocks, bs, max_blocks, blocks_per_split,
          1.0f / sqrtf((float)D));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_decode_merge_kernel<T, D><<<dim3(nh, B), kDecodeThreads, 0, stream>>>(
      work, static_cast<T*>(out), nh, n_split);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_decode(int hd, const void* q, const void* k_pool,
                            const void* v_pool, const int* tables,
                            const int* seq_lens, void* out, float* work,
                            int B, int nh, int num_blocks, int bs,
                            int max_blocks, int blocks_per_split,
                            cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch_decode<T, 64>(q, k_pool, v_pool, tables, seq_lens, out,
                                  work, B, nh, num_blocks, bs, max_blocks,
                                  blocks_per_split, stream);
    case 128:
      return launch_decode<T, 128>(q, k_pool, v_pool, tables, seq_lens, out,
                                   work, B, nh, num_blocks, bs, max_blocks,
                                   blocks_per_split, stream);
    case 256:
      return launch_decode<T, 256>(q, k_pool, v_pool, tables, seq_lens, out,
                                   work, B, nh, num_blocks, bs, max_blocks,
                                   blocks_per_split, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace ptt

// q [B, nh, hd], pools [nh, num_blocks, bs, hd], tables [B, max_blocks]
// int32, seq_lens [B] int32, out like q; all contiguous on the device.
// work: fp32 scratch of [B, nh, n_split, hd + 2], n_split = ceil(max_blocks
// / blocks_per_split) (at most 128; blocks_per_split at most 256).  hd in
// 64/128/256.  dtype: 0 = float32, 1 = bfloat16, 2 = float16.  Returns
// the launches' cudaError_t.
extern "C" int ptt_paged_decode(const void* q, const void* k_pool,
                                const void* v_pool, const void* tables,
                                const void* seq_lens, void* out, void* work,
                                int B, int nh, int hd, int num_blocks, int bs,
                                int max_blocks, int blocks_per_split,
                                int dtype, void* stream) {
  if (B <= 0 || nh <= 0 || bs <= 0 || max_blocks <= 0 ||
      blocks_per_split <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tables);
  const int* lens = static_cast<const int*>(seq_lens);
  float* w = static_cast<float*>(work);
  cudaError_t err =
      dtype == 1 ? ptt::dispatch_decode<__nv_bfloat16>(
                       hd, q, k_pool, v_pool, t, lens, out, w, B, nh,
                       num_blocks, bs, max_blocks, blocks_per_split, st)
      : dtype == 2 ? ptt::dispatch_decode<__half>(
                         hd, q, k_pool, v_pool, t, lens, out, w, B, nh,
                         num_blocks, bs, max_blocks, blocks_per_split, st)
      : dtype == 0 ? ptt::dispatch_decode<float>(
                         hd, q, k_pool, v_pool, t, lens, out, w, B, nh,
                         num_blocks, bs, max_blocks, blocks_per_split, st)
                   : cudaErrorInvalidValue;
  return (int)err;
}
