// The fused optimizer step for Hopper (sm_90a): AMP unscale, the finite
// check, gradient clipping, the update (Adam / AdamW, SGD, Momentum) with
// a skip on overflow, and the GradScaler's bookkeeping, over every
// parameter of a model in two launches.
//
// Replaces no Pallas kernel: the JAX package runs this step as one XLA
// program over the whole parameter tree (paddle_tpu/optimizer/fused.py,
// `_build_program`), and Paddle itself runs it as multi-tensor CUDA
// kernels (fused_adam_kernel.h, multi_tensor_adam).  The update rule is
// the JAX package's `_AdamBase.rule` (paddle_tpu/optimizer/optimizer.py).
//
// The tensors are described by a table in device memory, one row of
// kDescWords 64-bit words per tensor (built once per parameter list by
// ops/fused_optimizer.py): the parameter, the two state tensors, the
// float32 master (O2) and their element count, the tensor's first chunk,
// its weight decay and learning-rate ratio, and flags (types, need_clip,
// 16-byte alignment; a gradient's is checked where it is read).  The
// gradients' addresses change from step to step (autograd allocates them
// anew), so they sit in a second array, written
// each step by `table_upload_kernel` from its kernel arguments: no copy
// from the host, so no step ever waits for the card.  Each tensor is cut
// into chunks of `chunk` elements; one block takes one chunk.  Counts and
// offsets are 64-bit (GPT-3 1.3B's embedding alone is 103 M elements,
// 412 MB in float32).
//
// Launch 1, `fused_norm_kernel`: per chunk the sum of squares of the
// unscaled gradient (g * 1/scale, rounded to the gradient's type, as the
// JAX program's `g * inv.astype(g.dtype)`) in float32 and whether any of
// it is not finite.  The last block to finish (an atomic ticket) reduces
// the chunk sums in double, in chunk order (deterministic): to the global
// norm (ClipGradByGlobalNorm: coef = clip / max(norm, clip)) or to each
// tensor's norm (ClipGradByNorm: coef = clip / max(norm, 1e-12) where
// norm > clip), writes a coefficient per tensor, `found_inf`, the
// applied-step count (+1 unless found_inf) and the GradScaler's new
// scale, good, bad and skip counts, and resets the ticket.  Without a
// scaler and without a norm clip the launch is one block that only does
// that bookkeeping.
//
// Split norm (tensor parallelism, ZeRO: each rank holds a part of the
// gradients).  With `tsum` the last block of launch 1 stops at this
// rank's part: per tensor the sum of its chunks in double, times the
// tensor's norm weight (the float in the high half of its flags word: 1
// for a tensor the ranks split, 1 / (ranks that hold the same copy) for
// one they replicate), into tsum[t], and the non-finite flag into
// tsum[n_tensors].  The caller all-reduces (sums) tsum over the ranks'
// groups, then `fused_finish_kernel`, one block, turns it into the
// coefficients, found_inf, the applied-step count and the scaler's
// bookkeeping, exactly as the last block does without a split.
//
// Launch 2, `fused_update_kernel`: reads found_inf, the learning rate, the
// inverse scale and the applied-step count from device memory (so the
// pair can be captured in a CUDA graph).  Per element: unscale, clip (the
// tensor's coefficient, or a clamp for ClipGradByValue), then the rule on
// the float32 weight (the master under O2, whose 16-bit copy is written
// beside it).  Adam's bias correction uses the applied-step count.  With
// a scaler it also writes the unscaled gradient g * (1 / scale), rounded
// to the gradient's type, back over g: the JAX program returns those into
// p.grad on every scaler step, applied or skipped ("legacy parity: grads
// end up unscaled", paddle_tpu/optimizer/fused.py:399-401), so after a
// step p.grad is the same on every route.  On overflow (found_inf) the
// rule is skipped: without a scaler nothing is written (found_inf is
// never set there), with one only that gradient write runs.
//
// Types: float32 parameters (O1), or bfloat16 or float16 parameters with
// float32 masters (O2); a gradient has its parameter's type.  The
// unscaled and the global-norm-clipped gradient are rounded to that type,
// as the JAX program computes them in it.
//
// What bounds it: bytes.  Launch 1 reads each gradient once; launch 2
// reads p, g, m, v and writes p, m, v: 4 + 28 bytes a parameter in
// float32, and 4 more with a scaler, the gradient written back (O2: g 2,
// master, m, v 12 read; master, m, v 12, p 2 and with a scaler g 2
// written).  GPT-3 1.3B's 1.32 G parameters: 42 GB, 12.6 ms at 3.35 TB/s;
// 47 GB, 14.1 ms with a scaler.  Loads are 16-byte vectors of 4 elements
// (8 bytes for a 16-bit type) with a scalar tail; a tensor whose pointers
// are not 16-byte aligned takes the scalar loop.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace ptt {

constexpr int kFusedThreads = 256;
constexpr int kDescWords = 8;
constexpr int kUploadWords = 480;       // 3840 bytes of kernel arguments

// desc words
constexpr int kP = 0, kM = 1, kV = 2, kMaster = 3, kNumel = 4,
              kChunkBegin = 5, kHyper = 6, kFlags = 7;
// flags
constexpr long long kPBf16 = 1, kGBf16 = 2, kNeedClip = 4, kAligned = 8,
                    kPF16 = 16, kGF16 = 32;
// the high 32 bits of the flags word: the tensor's norm weight (a float)
// clip kinds
constexpr int kClipNone = 0, kClipGlobal = 1, kClipNorm = 2, kClipValue = 3;
// rules
constexpr int kRuleAdam = 0, kRuleSgd = 1, kRuleMomentum = 2;
// workspace slots: wsf float [inv_used, lr]; wsi int [ticket, found_acc,
// found]; scaler sc_f float [scale]; sc_i int [found, good, bad, nskip];
// step int [1], the optimizer's applied-step count
constexpr int kInv = 0, kLr = 1;
constexpr int kTicket = 0, kFoundAcc = 1, kFound = 2;

struct UploadArgs {
  long long w[kUploadWords];
};

__global__ void table_upload_kernel(UploadArgs a, long long* dst, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = a.w[i];
}

// x rounded to the type T (round to nearest even), back as a float.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __bfloat162float(__float2bfloat16_rn(x));
  else if constexpr (std::is_same<T, __half>::value)
    return __half2float(__float2half_rn(x));
  else
    return x;
}

__device__ __forceinline__ float lo_float(long long w) {
  return __int_as_float((int)(unsigned int)(w & 0xffffffffll));
}

__device__ __forceinline__ float hi_float(long long w) {
  return __int_as_float((int)(unsigned int)((unsigned long long)w >> 32));
}

// The tensor that owns chunk b: the last t with chunk_begin[t] <= b.
__device__ __forceinline__ int find_tensor(const long long* desc, int n,
                                           long long b) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (desc[(size_t)mid * kDescWords + kChunkBegin] <= b) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// 4 consecutive elements as floats, from a 16-byte (float) or 8-byte
// (bfloat16) aligned address.
__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* f) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
}

__device__ __forceinline__ void load4(const __half* p, float* f) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* f) {
  __nv_bfloat162 a = __floats2bfloat162_rn(f[0], f[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(f[2], f[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ void store4(__half* p, const float* f) {
  __half2 a = __floats2half2_rn(f[0], f[1]);
  __half2 b = __floats2half2_rn(f[2], f[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load1(const __half* p) {
  return __half2float(*p);
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store1(__half* p, float x) {
  *p = __float2half_rn(x);
}

// Deterministic block sums: warp shuffles in a fixed order, then warp 0
// over the warps' partial sums.
template <typename T>
__device__ __forceinline__ T block_sum(T x, T* smem) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();                       // smem may hold an earlier sum
  if (lane == 0) smem[warp] = x;
  __syncthreads();
  const int nwarps = (blockDim.x + 31) >> 5;
  x = lane < nwarps ? smem[lane] : T(0);
  if (warp == 0) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    if (lane == 0) smem[0] = x;
  }
  __syncthreads();
  return smem[0];
}

// Sum of squares and non-finite flag of one chunk's unscaled gradient.
template <typename GT>
__device__ void chunk_norm(const GT* g, long long start, long long end,
                           bool aligned, float inv, float& sq, int& bad) {
  long long i = start + 4 * (long long)threadIdx.x;
  const long long vend = aligned ? start + ((end - start) & ~3ll) : start;
  for (; i < vend; i += 4 * (long long)blockDim.x) {
    float f[4];
    load4(g + i, f);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float u = round_to<GT>(f[k] * inv);
      bad |= !isfinite(u);
      sq += u * u;
    }
  }
  for (long long j = vend + threadIdx.x; j < end; j += blockDim.x) {
    const float u = round_to<GT>(load1(g + j) * inv);
    bad |= !isfinite(u);
    sq += u * u;
  }
}

// The last block's bookkeeping (thread 0): the inverse scale used,
// found_inf, the applied-step count, and GradScaler.update() as the JAX
// program replays it on device; resets the ticket and the accumulator.
__device__ void step_bookkeeping(float* wsf, int* wsi, int* step, float* sc_f,
                                 int* sc_i, float inv, int found,
                                 int dynamic, float incr_ratio,
                                 float decr_ratio, int incr_every,
                                 int decr_every) {
  wsf[kInv] = inv;
  wsi[kFound] = found;
  if (!found) step[0] += 1;
  wsi[kTicket] = 0;
  wsi[kFoundAcc] = 0;
  if (sc_f == nullptr) return;
  const float scale = sc_f[0];
  int good = sc_i[1], bad = sc_i[2];
  if (dynamic) {
    const int bad1 = bad + 1, good1 = good + 1;
    const bool dec = bad1 >= decr_every, inc = good1 >= incr_every;
    float scale2 = scale;
    if (found) {
      if (dec) scale2 = fmaxf(scale * decr_ratio, 1.0f);
      good = 0;
      bad = dec ? 0 : bad1;
    } else {
      if (inc) scale2 = scale * incr_ratio;
      good = inc ? 0 : good1;
      bad = 0;
    }
    sc_f[0] = scale2;
  }
  sc_i[0] = found;
  sc_i[1] = good;
  sc_i[2] = bad;
  sc_i[3] += found;
}

__global__ void __launch_bounds__(kFusedThreads)
    fused_norm_kernel(const long long* __restrict__ desc,
                      const long long* __restrict__ gptr, int n_tensors,
                      long long chunk, float* __restrict__ partials,
                      float* __restrict__ coef, float* wsf, int* wsi,
                      int* step, float* sc_f, int* sc_i, double* tsum,
                      int clip_kind, float clip_norm,
                      int scan, int dynamic, float incr_ratio,
                      float decr_ratio, int incr_every, int decr_every) {
  __shared__ float s_f[32];
  __shared__ double s_d[32];
  __shared__ int s_last;
  const bool use_scaler = sc_f != nullptr;
  const float inv = use_scaler ? 1.0f / sc_f[0] : 1.0f;
  if (scan) {
    const long long b = blockIdx.x;
    const int t = find_tensor(desc, n_tensors, b);
    const long long* d = desc + (size_t)t * kDescWords;
    const long long flags = d[kFlags];
    const long long start = (b - d[kChunkBegin]) * chunk;
    const long long end = min(start + chunk, d[kNumel]);
    const bool aligned = (flags & kAligned) && !(gptr[t] & 15);
    float sq = 0.f;
    int bad = 0;
    if (flags & kGBf16)
      chunk_norm(reinterpret_cast<const __nv_bfloat16*>(gptr[t]), start, end,
                 aligned, round_to<__nv_bfloat16>(inv), sq, bad);
    else if (flags & kGF16)
      chunk_norm(reinterpret_cast<const __half*>(gptr[t]), start, end,
                 aligned, round_to<__half>(inv), sq, bad);
    else
      chunk_norm(reinterpret_cast<const float*>(gptr[t]), start, end,
                 aligned, inv, sq, bad);
    sq = block_sum(sq, s_f);
    const int any_bad = __syncthreads_or(bad);
    if (threadIdx.x == 0) {
      partials[b] = (flags & kNeedClip) ? sq : 0.f;
      if (any_bad && use_scaler) atomicOr(wsi + kFoundAcc, 1);
      __threadfence();
      s_last = atomicAdd(wsi + kTicket, 1) == (int)gridDim.x - 1;
    }
    __syncthreads();
    if (!s_last) return;
    __threadfence();
  }
  // the last block: reduce, then the bookkeeping
  const int found = use_scaler ? (__ldcg(wsi + kFoundAcc) != 0) : 0;
  if (tsum != nullptr) {
    // split: this rank's weighted per-tensor sums and its flag; the
    // caller reduces them over the ranks and fused_finish_kernel goes on
    for (int t = threadIdx.x; t < n_tensors; t += blockDim.x) {
      const long long* d = desc + (size_t)t * kDescWords;
      const long long c1 = t + 1 < n_tensors
                               ? d[kDescWords + kChunkBegin]
                               : (long long)gridDim.x;
      double s = 0.0;
      for (long long c = d[kChunkBegin]; c < c1; ++c)
        s += (double)__ldcg(partials + c);
      tsum[t] = s * (double)hi_float(d[kFlags]);
    }
    if (threadIdx.x == 0) {
      tsum[n_tensors] = (double)found;
      wsi[kTicket] = 0;
      wsi[kFoundAcc] = 0;
    }
    return;
  }
  if (clip_kind == kClipGlobal) {
    double s = 0.0;
    for (int c = threadIdx.x; c < (int)gridDim.x; c += blockDim.x)
      s += (double)__ldcg(partials + c);
    s = block_sum(s, s_d);
    const float norm = sqrtf((float)s);
    const float cg = clip_norm / fmaxf(norm, clip_norm);
    for (int t = threadIdx.x; t < n_tensors; t += blockDim.x)
      coef[t] = (desc[(size_t)t * kDescWords + kFlags] & kNeedClip) ? cg
                                                                     : 1.f;
  } else if (clip_kind == kClipNorm) {
    for (int t = threadIdx.x; t < n_tensors; t += blockDim.x) {
      const long long* d = desc + (size_t)t * kDescWords;
      const long long c1 = t + 1 < n_tensors
                               ? d[kDescWords + kChunkBegin]
                               : (long long)gridDim.x;
      double s = 0.0;
      for (long long c = d[kChunkBegin]; c < c1; ++c)
        s += (double)__ldcg(partials + c);
      const float norm = sqrtf((float)s);
      coef[t] = ((d[kFlags] & kNeedClip) && norm > clip_norm)
                    ? clip_norm / fmaxf(norm, 1e-12f)
                    : 1.f;
    }
  } else {
    for (int t = threadIdx.x; t < n_tensors; t += blockDim.x) coef[t] = 1.f;
  }
  if (threadIdx.x == 0)
    step_bookkeeping(wsf, wsi, step, sc_f, sc_i, inv, found, dynamic,
                     incr_ratio, decr_ratio, incr_every, decr_every);
}

// After a split launch 1 and the caller's reduction of tsum over the
// ranks: the clip coefficients from the global per-tensor sums,
// found_inf from the summed flags, and the bookkeeping.  One block.
__global__ void __launch_bounds__(kFusedThreads)
    fused_finish_kernel(const long long* __restrict__ desc, int n_tensors,
                        const double* __restrict__ tsum,
                        float* __restrict__ coef, float* wsf, int* wsi,
                        int* step, float* sc_f, int* sc_i, int clip_kind,
                        float clip_norm, int dynamic, float incr_ratio,
                        float decr_ratio, int incr_every, int decr_every) {
  __shared__ double s_d[32];
  const bool use_scaler = sc_f != nullptr;
  const float inv = use_scaler ? 1.0f / sc_f[0] : 1.0f;
  const int found = use_scaler ? (tsum[n_tensors] > 0.0) : 0;
  if (clip_kind == kClipGlobal) {
    double s = 0.0;
    for (int t = threadIdx.x; t < n_tensors; t += blockDim.x) s += tsum[t];
    s = block_sum(s, s_d);
    const float norm = sqrtf((float)s);
    const float cg = clip_norm / fmaxf(norm, clip_norm);
    for (int t = threadIdx.x; t < n_tensors; t += blockDim.x)
      coef[t] = (desc[(size_t)t * kDescWords + kFlags] & kNeedClip) ? cg
                                                                     : 1.f;
  } else if (clip_kind == kClipNorm) {
    for (int t = threadIdx.x; t < n_tensors; t += blockDim.x) {
      const float norm = sqrtf((float)tsum[t]);
      coef[t] = ((desc[(size_t)t * kDescWords + kFlags] & kNeedClip) &&
                 norm > clip_norm)
                    ? clip_norm / fmaxf(norm, 1e-12f)
                    : 1.f;
    }
  } else {
    for (int t = threadIdx.x; t < n_tensors; t += blockDim.x) coef[t] = 1.f;
  }
  if (threadIdx.x == 0)
    step_bookkeeping(wsf, wsi, step, sc_f, sc_i, inv, found, dynamic,
                     incr_ratio, decr_ratio, incr_every, decr_every);
}

struct Rule {
  int rule, decoupled, nesterov, clip_kind, use_scaler, need_clip;
  float b1, b2, eps, mu, lo, hi, lr, wd, coef, inv_g, bc1, bc2;
};

// One element: the unscaled gradient u, the float32 weight w and states
// m, v; updates w, m, v in place.  GT: the gradient's type.
template <typename GT>
__device__ __forceinline__ void update1(const Rule& r, float u, float& w,
                                        float& m, float& v) {
  if (r.need_clip) {
    if (r.clip_kind == kClipGlobal) {
      u = round_to<GT>(u * r.coef);
    } else if (r.clip_kind == kClipNorm) {
      u = u * r.coef;
    } else if (r.clip_kind == kClipValue) {
      u = fminf(fmaxf(u, r.lo), r.hi);
    }
  }
  if (r.rule == kRuleAdam) {
    if (r.wd != 0.f && !r.decoupled) u = u + r.wd * w;
    m = r.b1 * m + (1.f - r.b1) * u;
    v = r.b2 * v + (1.f - r.b2) * (u * u);
    const float mhat = m / r.bc1, vhat = v / r.bc2;
    float upd = mhat / (sqrtf(vhat) + r.eps);
    if (r.wd != 0.f && r.decoupled) upd = upd + r.wd * w;
    w = w - r.lr * upd;
  } else {
    if (r.wd != 0.f) u = u + r.wd * w;
    if (r.rule == kRuleSgd) {
      w = w - r.lr * u;
    } else {
      const float v2 = r.mu * m + u;
      w = w - r.lr * (r.nesterov ? u + r.mu * v2 : v2);
      m = v2;
    }
  }
}

// One chunk of one tensor.  PT: the parameter's type (bfloat16 or
// float16 only with a float32 master); GT: the gradient's.  With a scaler
// the unscaled gradient goes back over g; `skip` (found_inf) runs only
// that write.
template <typename PT, typename GT>
__device__ void update_chunk(const Rule& r, const long long* d,
                             GT* __restrict__ g, long long start,
                             long long end, bool skip) {
  PT* p = reinterpret_cast<PT*>(d[kP]);
  float* m = reinterpret_cast<float*>(d[kM]);
  float* v = reinterpret_cast<float*>(d[kV]);
  float* master = reinterpret_cast<float*>(d[kMaster]);
  const bool has_m = m != nullptr, has_v = v != nullptr;
  const bool aligned =
      (d[kFlags] & kAligned) && !(reinterpret_cast<uintptr_t>(g) & 15);
  const long long vend = aligned ? start + ((end - start) & ~3ll) : start;
  for (long long i = start + 4 * (long long)threadIdx.x; i < vend;
       i += 4 * (long long)blockDim.x) {
    float gf[4], w[4], mf[4] = {0.f, 0.f, 0.f, 0.f},
                       vf[4] = {0.f, 0.f, 0.f, 0.f};
    load4(g + i, gf);
    if (r.use_scaler) {
#pragma unroll
      for (int k = 0; k < 4; ++k) gf[k] = round_to<GT>(gf[k] * r.inv_g);
      store4(g + i, gf);
    }
    if (skip) continue;
    if (master != nullptr) load4(master + i, w);
    else load4(p + i, w);
    if (has_m) load4(m + i, mf);
    if (has_v) load4(v + i, vf);
#pragma unroll
    for (int k = 0; k < 4; ++k) update1<GT>(r, gf[k], w[k], mf[k], vf[k]);
    if (master != nullptr) store4(master + i, w);
    store4(p + i, w);
    if (has_m) store4(m + i, mf);
    if (has_v) store4(v + i, vf);
  }
  for (long long j = vend + threadIdx.x; j < end; j += blockDim.x) {
    float u = load1(g + j);
    if (r.use_scaler) {
      u = round_to<GT>(u * r.inv_g);
      store1(g + j, u);
    }
    if (skip) continue;
    float w = master != nullptr ? master[j] : load1(p + j);
    float mj = has_m ? m[j] : 0.f, vj = has_v ? v[j] : 0.f;
    update1<GT>(r, u, w, mj, vj);
    if (master != nullptr) master[j] = w;
    store1(p + j, w);
    if (has_m) m[j] = mj;
    if (has_v) v[j] = vj;
  }
}

__global__ void __launch_bounds__(kFusedThreads)
    fused_update_kernel(const long long* __restrict__ desc,
                        const long long* __restrict__ gptr, int n_tensors,
                        long long chunk, const float* __restrict__ coef,
                        const float* __restrict__ wsf,
                        const int* __restrict__ wsi,
                        const int* __restrict__ step_count, int rule,
                        int decoupled,
                        int nesterov, float b1, float b2, float eps, float mu,
                        int clip_kind, float lo, float hi, int use_scaler) {
  // overflow: the step is skipped; a scaler's unscaled gradients are
  // still written (found_inf is set only with a scaler)
  const bool skip = wsi[kFound] != 0;
  if (skip && !use_scaler) return;
  const long long b = blockIdx.x;
  const int t = find_tensor(desc, n_tensors, b);
  const long long* d = desc + (size_t)t * kDescWords;
  const long long flags = d[kFlags];
  const long long start = (b - d[kChunkBegin]) * chunk;
  const long long end = min(start + chunk, d[kNumel]);
  const float step = (float)step_count[0];
  Rule r;
  r.rule = rule;
  r.decoupled = decoupled;
  r.nesterov = nesterov;
  r.clip_kind = clip_kind;
  r.use_scaler = use_scaler;
  r.need_clip = (flags & kNeedClip) != 0;
  r.b1 = b1;
  r.b2 = b2;
  r.eps = eps;
  r.mu = mu;
  r.lo = lo;
  r.hi = hi;
  r.lr = wsf[kLr] * hi_float(d[kHyper]);
  r.wd = lo_float(d[kHyper]);
  r.coef = coef[t];
  r.inv_g = (flags & kGBf16)  ? round_to<__nv_bfloat16>(wsf[kInv])
            : (flags & kGF16) ? round_to<__half>(wsf[kInv])
                              : wsf[kInv];
  r.bc1 = 1.f - powf(b1, step);
  r.bc2 = 1.f - powf(b2, step);
  // a gradient has its parameter's type (the table's flags set both)
  void* g = reinterpret_cast<void*>(gptr[t]);
  if (flags & kPBf16)
    update_chunk<__nv_bfloat16, __nv_bfloat16>(
        r, d, static_cast<__nv_bfloat16*>(g), start, end, skip);
  else if (flags & kPF16)
    update_chunk<__half, __half>(r, d, static_cast<__half*>(g), start, end,
                                 skip);
  else
    update_chunk<float, float>(r, d, static_cast<float*>(g), start, end,
                               skip);
}

}  // namespace ptt

// Copies n 64-bit words from host memory into dst on the device, through
// the arguments of one small launch per 480 words (no copy from host
// memory, so the caller never waits for the card).  Returns the launches'
// cudaError_t.
extern "C" int ptt_fused_table_upload(void* dst, const void* src,
                                      long long n, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  const long long* s = static_cast<const long long*>(src);
  long long* out = static_cast<long long*>(dst);
  for (long long off = 0; off < n; off += ptt::kUploadWords) {
    const int cnt = (int)(n - off < ptt::kUploadWords ? n - off
                                                      : ptt::kUploadWords);
    ptt::UploadArgs a;
    for (int i = 0; i < cnt; ++i) a.w[i] = s[off + i];
    ptt::table_upload_kernel<<<1, 256, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        a, out + off, cnt);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

// Launch 1 (see the head of the file).  desc [n_tensors * 8] and gptr
// [n_tensors] int64; partials [n_chunks] float; coef [n_tensors] float;
// wsf float [2]; wsi int [3]; step int [1]; sc_f float [1] and sc_i int
// [4], both null
// without a scaler.  scan = 0 (no scaler, no norm clip) runs one block
// of bookkeeping.  tsum: null, or double [n_tensors + 1] for the split
// norm (with scan = 1; see the head of the file).  Returns the launch's
// cudaError_t.
extern "C" int ptt_fused_norm(const void* desc, const void* gptr,
                              int n_tensors, int n_chunks, long long chunk,
                              void* partials, void* coef, void* wsf,
                              void* wsi, void* step, void* sc_f, void* sc_i,
                              void* tsum, int clip_kind, float clip_norm,
                              int scan,
                              int dynamic, float incr_ratio, float decr_ratio,
                              int incr_every, int decr_every, void* stream) {
  if (n_tensors <= 0 || n_chunks <= 0 || chunk <= 0 || chunk % 4 ||
      (sc_f == nullptr) != (sc_i == nullptr) || (tsum != nullptr && !scan))
    return (int)cudaErrorInvalidValue;
  ptt::fused_norm_kernel<<<scan ? n_chunks : 1, ptt::kFusedThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(desc), static_cast<const long long*>(gptr),
      n_tensors, chunk, static_cast<float*>(partials),
      static_cast<float*>(coef), static_cast<float*>(wsf),
      static_cast<int*>(wsi), static_cast<int*>(step),
      static_cast<float*>(sc_f),
      static_cast<int*>(sc_i), static_cast<double*>(tsum), clip_kind,
      clip_norm, scan, dynamic, incr_ratio, decr_ratio, incr_every,
      decr_every);
  return (int)cudaGetLastError();
}

// The end of a split launch 1, after the caller's reduction of tsum
// (double [n_tensors + 1]): coefficients, found_inf and the bookkeeping,
// one block.  Arguments as ptt_fused_norm's.  Returns the launch's
// cudaError_t.
extern "C" int ptt_fused_finish(const void* desc, int n_tensors,
                                const void* tsum, void* coef, void* wsf,
                                void* wsi, void* step, void* sc_f,
                                void* sc_i, int clip_kind, float clip_norm,
                                int dynamic, float incr_ratio,
                                float decr_ratio, int incr_every,
                                int decr_every, void* stream) {
  if (n_tensors <= 0 || tsum == nullptr ||
      (sc_f == nullptr) != (sc_i == nullptr))
    return (int)cudaErrorInvalidValue;
  ptt::fused_finish_kernel<<<1, ptt::kFusedThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(desc), n_tensors,
      static_cast<const double*>(tsum), static_cast<float*>(coef),
      static_cast<float*>(wsf), static_cast<int*>(wsi),
      static_cast<int*>(step), static_cast<float*>(sc_f),
      static_cast<int*>(sc_i), clip_kind, clip_norm, dynamic, incr_ratio,
      decr_ratio, incr_every, decr_every);
  return (int)cudaGetLastError();
}

// Launch 2 (see the head of the file).  rule: 0 Adam (decoupled: AdamW),
// 1 SGD, 2 Momentum (mu, nesterov).  use_scaler: the gradients are
// unscaled, and written back unscaled.  Returns the launch's cudaError_t.
extern "C" int ptt_fused_update(const void* desc, const void* gptr,
                                int n_tensors, int n_chunks, long long chunk,
                                const void* coef, const void* wsf,
                                const void* wsi, const void* step, int rule,
                                int decoupled,
                                int nesterov, float b1, float b2, float eps,
                                float mu, int clip_kind, float lo, float hi,
                                int use_scaler, void* stream) {
  if (n_tensors <= 0 || n_chunks <= 0 || chunk <= 0 || chunk % 4 ||
      rule < 0 || rule > 2)
    return (int)cudaErrorInvalidValue;
  ptt::fused_update_kernel<<<n_chunks, ptt::kFusedThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(desc), static_cast<const long long*>(gptr),
      n_tensors, chunk, static_cast<const float*>(coef),
      static_cast<const float*>(wsf), static_cast<const int*>(wsi),
      static_cast<const int*>(step), rule,
      decoupled, nesterov, b1, b2, eps, mu, clip_kind, lo, hi, use_scaler);
  return (int)cudaGetLastError();
}
