// FlashAttention backward for Hopper (sm_90a), plain FMA on CUDA cores:
// two kernels, flash_bwd_dq and flash_bwd_dkv.
//
// Replace the Pallas TPU kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel` in
// paddle_tpu/ops/pallas_flash.py (driven by `_flash_bwd`): the backward of
// the training step's attention (ops/flash_attention.py FlashAttention).
//
// For q [B, Sq, nh, hd], k, v [B, Sk, nkv, hd], the forward's out and lse
// [B, nh, Sq] and the output gradient dO (like q), with the FlashAttention-2
// identities (never the S x S matrices in device memory):
//   p  = exp(q k^T * scale - lse)          0 on masked entries
//   D  = rowsum(dO * out)                  per query row, in the block
//   dp = dO v^T, dropped and / keep_p by the forward's keep bits
//   ds = p * (dp - D) * scale
//   dq = ds k                               flash_bwd_dq
//   dv = (keep ? p / keep_p : 0)^T dO,  dk = ds^T q      flash_bwd_dkv
// Masks are the forward's: end-aligned causal (key <= i + Sk - Sq), the
// optional key mask [B, Sk] int32, ragged tiles.  p is zeroed explicitly
// on every masked entry: a fully masked row has lse = -1e30, and a -1e30
// score would give exp(0) = 1 there.
//
// Layout on the card.  The TPU kernels walk their reduction axis as the
// last, sequential grid dimension with the sum in VMEM scratch; blocks on
// the card run in no order, so each walk is a loop inside one block with
// the sum in registers, written once (deterministic, no atomics):
// - flash_bwd_dq: one block of 256 threads per (batch * head, tile of BQ
//   query rows), looping over key tiles up to the causal diagonal;
// - flash_bwd_dkv: one block per (batch * KV head, tile of BK key rows),
//   looping over the query heads of its group (grouped-query attention:
//   the sum over the group happens in the block's fp32 registers, not in a
//   per-query-head [B, nh, Sk, hd] buffer as on the TPU) and, for each, over
//   the query tiles from the causal diagonal on.
// Tiles are 64 x 64 for hd 64 and 128, and 32 x 32 for hd 256, so that
// four fp32 tiles of hd columns fit in the 227 KB of shared memory.
//
// What bounds it: per (query, key) pair the two kernels do 6 hd (dq) and
// 8 hd (dk/dv) flops on O(S hd) elements, far above the H100's ~295 flops
// per byte, so arithmetic bounds them.  This first version computes with
// fp32 FMAs (67 TFLOP/s peak), not the tensor cores (989 TFLOP/s bf16);
// what it does do is keep the score matrices out of device memory, stage
// each tile in shared memory once for a whole tile of the other side, and
// skip the tiles above the causal diagonal.  wgmma + TMA is the later step.
#include "attention_common.cuh"

namespace ptt {

struct BwdArgs {
  const void *q, *k, *v, *o, *dO;
  const float* lse;
  const int* mask;        // [B, Sk] int32, or null
  void *dq, *dk, *dv;
  int B, Sq, Sk, nh, nkv, causal;
  float scale;
  unsigned seed, thresh;  // dropout on when thresh > 0
  float keep_p;
};

template <int D, int BQ, int BK>
struct BwdSmem {
  float q[BQ][D + 1];
  float dO[BQ][D + 1];
  float k[BK][D + 1];
  float v[BK][D + 1];
  float ds[BQ][BK + 1];
  float pd[BQ][BK + 1];   // dropped p / keep_p (flash_bwd_dkv only)
  float lse[BQ], delta[BQ];
  long long qoff[BQ];     // element offset of each query row, -1 = none
  long long koff[BK];     // element offset of each key row, -1 = none
  int kok[BK];            // key present and not masked
};

// Stage the query side of a tile (q, dO, lse) and compute D = rowsum(dO *
// out) for its rows: kThreads / BQ neighbouring lanes per row.
template <typename T, int D, int BQ, int BK>
__device__ __forceinline__ void stage_query_tile(BwdSmem<D, BQ, BK>& sm,
                                                 const BwdArgs& a, int b,
                                                 int h, int q0) {
  const int tid = threadIdx.x;
  if (tid < BQ) {
    const int qp = q0 + tid;
    const bool in = qp < a.Sq;
    sm.qoff[tid] =
        in ? ((long long)(b * (long long)a.Sq + qp) * a.nh + h) * D : -1;
    sm.lse[tid] = in ? a.lse[((long long)b * a.nh + h) * a.Sq + qp] : 0.f;
  }
  __syncthreads();
  load_rows<T, D, D + 1, BQ>(sm.q, static_cast<const T*>(a.q), sm.qoff);
  load_rows<T, D, D + 1, BQ>(sm.dO, static_cast<const T*>(a.dO), sm.qoff);
  __syncthreads();
  constexpr int TPR = kThreads / BQ;
  const int row = tid / TPR, sub = tid % TPR;
  const long long off = sm.qoff[row];
  float sum = 0.f;
  if (off >= 0) {
    const T* o = static_cast<const T*>(a.o) + off;
    for (int c = sub * 4; c < D; c += 4 * TPR) {
      float f[4];
      load4(o + c, f);
#pragma unroll
      for (int e = 0; e < 4; ++e) sum = fmaf(f[e], sm.dO[row][c + e], sum);
    }
  }
#pragma unroll
  for (int w = 1; w < TPR; w <<= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, w);
  if (sub == 0) sm.delta[row] = sum;
  __syncthreads();
}

// Stage the key side of a tile (k, v rows and which keys are valid).
template <typename T, int D, int BQ, int BK>
__device__ __forceinline__ void stage_key_tile(BwdSmem<D, BQ, BK>& sm,
                                               const BwdArgs& a, int b,
                                               int hk, int k0, int k_end) {
  const int tid = threadIdx.x;
  if (tid < BK) {
    const int kp = k0 + tid;
    const long long row = b * (long long)a.Sk + kp;
    const bool in = kp < k_end;
    sm.koff[tid] = in ? (row * a.nkv + hk) * D : -1;
    sm.kok[tid] = in && (a.mask == nullptr || a.mask[row] != 0);
  }
  __syncthreads();
  load_rows<T, D, D + 1, BK>(sm.k, static_cast<const T*>(a.k), sm.koff);
  load_rows<T, D, D + 1, BK>(sm.v, static_cast<const T*>(a.v), sm.koff);
  __syncthreads();
}

// For the staged tiles: thread (ty, tx) computes the scores of query rows
// ty + 16 i and keys tx + 16 j, and writes ds (and, with PD, the dropped p)
// to shared memory.
template <int D, int BQ, int BK, bool PD>
__device__ __forceinline__ void tile_ds(BwdSmem<D, BQ, BK>& sm,
                                        const BwdArgs& a, int q0, int k0,
                                        unsigned word) {
  constexpr int RQ = BQ / 16, RK = BK / 16;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[RQ][RK], dp[RQ][RK];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < RK; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[RQ], gv[RQ], kv[RK], vv[RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      qv[i] = sm.q[ty + 16 * i][d];
      gv[i] = sm.dO[ty + 16 * i][d];
    }
#pragma unroll
    for (int j = 0; j < RK; ++j) {
      kv[j] = sm.k[tx + 16 * j][d];
      vv[j] = sm.v[tx + 16 * j][d];
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
      }
  }
  const int offset = a.Sk - a.Sq;
  const bool drop = a.thresh > 0;
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < RK; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      const int qp = q0 + r, kp = k0 + c;
      const bool valid = sm.qoff[r] >= 0 && sm.kok[c] &&
                         (!a.causal || kp <= qp + offset);
      const float p = valid ? expf(s[i][j] * a.scale - sm.lse[r]) : 0.f;
      float g = dp[i][j], pk = p;
      if (drop) {
        const bool keep = dropout_keep(word, a.thresh, qp, kp);
        g = keep ? g / a.keep_p : 0.f;
        pk = keep ? p / a.keep_p : 0.f;
      }
      sm.ds[r][c] = p * (g - sm.delta[r]) * a.scale;
      if (PD) sm.pd[r][c] = pk;
    }
  __syncthreads();
}

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<BwdSmem<D, BQ, BK>*>(smem_raw);
  constexpr int RQ = BQ / 16;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / a.nh, h = bh % a.nh, hk = h / (a.nh / a.nkv);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const unsigned word = dropout_word(a.seed, bh);
  stage_query_tile<T, D, BQ, BK>(sm, a, b, h, q0);

  const int q_last = min(q0 + BQ, a.Sq) - 1;
  const int k_end =
      a.causal ? min(a.Sk, q_last + a.Sk - a.Sq + 1) : a.Sk;
  float acc[RQ][D / 16];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    stage_key_tile<T, D, BQ, BK>(sm, a, b, hk, k0, k_end);
    tile_ds<D, BQ, BK, false>(sm, a, q0, k0, word);
    // dq += ds k
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float dsv[RQ], kv[D / 16];
#pragma unroll
      for (int i = 0; i < RQ; ++i) dsv[i] = sm.ds[ty + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) kv[j] = sm.k[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < D / 16; ++j)
          acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
    __syncthreads();
  }
  T* dq = static_cast<T*>(a.dq);
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const long long o = sm.qoff[ty + 16 * i];
    if (o < 0) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      dq[o + tx + 16 * j] = from_float<T>(acc[i][j]);
  }
}

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<BwdSmem<D, BQ, BK>*>(smem_raw);
  constexpr int RK = BK / 16;
  const int k0 = blockIdx.x * BK;
  const int bhk = blockIdx.y;
  const int b = bhk / a.nkv, hk = bhk % a.nkv, group = a.nh / a.nkv;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  stage_key_tile<T, D, BQ, BK>(sm, a, b, hk, k0, a.Sk);

  // the first query row that sees key k0 is k0 - (Sk - Sq)
  const int q_begin =
      a.causal ? max(0, k0 - (a.Sk - a.Sq)) / BQ * BQ : 0;
  float dk[RK][D / 16], dv[RK][D / 16];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dk[i][j] = dv[i][j] = 0.f;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const unsigned word = dropout_word(a.seed, b * a.nh + h);
    for (int q0 = q_begin; q0 < a.Sq; q0 += BQ) {
      stage_query_tile<T, D, BQ, BK>(sm, a, b, h, q0);
      tile_ds<D, BQ, BK, true>(sm, a, q0, k0, word);
      // dv += pd^T dO, dk += ds^T q: thread owns keys ty + 16 i
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float pv[RK], sv[RK], gv[D / 16], qv[D / 16];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          pv[i] = sm.pd[r][ty + 16 * i];
          sv[i] = sm.ds[r][ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < D / 16; ++j) {
          gv[j] = sm.dO[r][tx + 16 * j];
          qv[j] = sm.q[r][tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < RK; ++i)
#pragma unroll
          for (int j = 0; j < D / 16; ++j) {
            dv[i][j] = fmaf(pv[i], gv[j], dv[i][j]);
            dk[i][j] = fmaf(sv[i], qv[j], dk[i][j]);
          }
      }
      __syncthreads();
    }
  }
  T* gk = static_cast<T*>(a.dk);
  T* gvp = static_cast<T*>(a.dv);
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const long long o = sm.koff[ty + 16 * i];
    if (o < 0) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      gk[o + tx + 16 * j] = from_float<T>(dk[i][j]);
      gvp[o + tx + 16 * j] = from_float<T>(dv[i][j]);
    }
  }
}

template <typename T, int D, int BQ, int BK>
cudaError_t launch_bwd(const BwdArgs& a, bool dkv, cudaStream_t stream) {
  const size_t smem = sizeof(BwdSmem<D, BQ, BK>);
  if (!dkv) {
    auto kernel = flash_bwd_dq_kernel<T, D, BQ, BK>;
    static const cudaError_t attr = allow_smem(kernel, smem);
    if (attr != cudaSuccess) return attr;
    dim3 grid((a.Sq + BQ - 1) / BQ, a.B * a.nh);
    kernel<<<grid, kThreads, smem, stream>>>(a);
  } else {
    auto kernel = flash_bwd_dkv_kernel<T, D, BQ, BK>;
    static const cudaError_t attr = allow_smem(kernel, smem);
    if (attr != cudaSuccess) return attr;
    dim3 grid((a.Sk + BK - 1) / BK, a.B * a.nkv);
    kernel<<<grid, kThreads, smem, stream>>>(a);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bwd(int hd, const BwdArgs& a, bool dkv,
                         cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch_bwd<T, 64, 64, 64>(a, dkv, stream);
    case 128:
      return launch_bwd<T, 128, 64, 64>(a, dkv, stream);
    case 256:
      return launch_bwd<T, 256, 32, 32>(a, dkv, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

int run_bwd(BwdArgs a, int hd, int dtype, bool dkv, void* stream) {
  if (a.B <= 0 || a.Sq <= 0 || a.Sk <= 0 || a.nkv <= 0 || a.nh % a.nkv)
    return (int)cudaErrorInvalidValue;
  a.scale = 1.0f / sqrtf((float)hd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 1   ? dispatch_bwd<__nv_bfloat16>(hd, a, dkv, s)
      : dtype == 0 ? dispatch_bwd<float>(hd, a, dkv, s)
                   : cudaErrorInvalidValue;
  return (int)err;
}

}  // namespace ptt

// q, out, dO, dq [B, Sq, nh, hd]; k, v, dk, dv [B, Sk, nkv, hd]; lse
// [B, nh, Sq] fp32; mask [B, Sk] int32 or null; all contiguous on the
// device.  dtype: 0 = float32, 1 = bfloat16.  seed, thresh and keep_p are
// the forward's (dropout on when thresh > 0).  Each returns the
// cudaError_t of its launch (0 = success).
extern "C" int ptt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* out, const void* dO,
                                const void* lse, void* dq, const void* mask,
                                int B, int Sq, int Sk, int nh, int nkv,
                                int hd, int causal, int dtype, unsigned seed,
                                unsigned thresh, float keep_p,
                                void* stream) {
  ptt::BwdArgs a{q, k, v, out, dO, static_cast<const float*>(lse),
                 static_cast<const int*>(mask), dq, nullptr, nullptr,
                 B, Sq, Sk, nh, nkv, causal, 0.f, seed, thresh, keep_p};
  return ptt::run_bwd(a, hd, dtype, false, stream);
}

extern "C" int ptt_flash_bwd_dkv(const void* q, const void* k,
                                 const void* v, const void* out,
                                 const void* dO, const void* lse, void* dk,
                                 void* dv, const void* mask, int B, int Sq,
                                 int Sk, int nh, int nkv, int hd, int causal,
                                 int dtype, unsigned seed, unsigned thresh,
                                 float keep_p, void* stream) {
  ptt::BwdArgs a{q, k, v, out, dO, static_cast<const float*>(lse),
                 static_cast<const int*>(mask), nullptr, dk, dv,
                 B, Sq, Sk, nh, nkv, causal, 0.f, seed, thresh, keep_p};
  return ptt::run_bwd(a, hd, dtype, true, stream);
}
