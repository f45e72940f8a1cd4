// FlashAttention forward for Hopper (sm_90a): two kernels, dispatched by
// type inside ptt_flash_fwd.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` in
// paddle_tpu/ops/pallas_flash.py:159 (driven by `flash_attention_fwd`):
// the whole-prompt prefill attention of the serving engine, and the
// forward of the training step's attention (ops/flash_attention.py
// FlashAttention).
//
// Computes, for q [B, Sq, nh, hd] against k, v [B, Sk, nkv, hd] (nh a
// multiple of nkv: grouped-query attention reads kv head h / (nh / nkv)),
//   out[b, i, h] = softmax(q k^T / sqrt(hd)) v        (fp32 accumulation)
//   lse[b, h, i] = log-sum-exp of the scaled scores   (fp32)
// with the end-aligned causal mask key <= i + (Sk - Sq) when causal.
// Any Sq and Sk: the ragged last tiles are masked, never padded by the
// caller.  An optional key mask [B, Sk] int32 (0 = padded key) drops keys
// as if they were not there: they are never read and score -inf (p = 0
// even in a row that is fully masked, which writes zeros and lse -1e30).
// Dropout (attention_common.cuh) drops the normalised probabilities: l
// sums the undropped p, the output the dropped ones.
//
// What bounds it: at prefill lengths attention does 4 hd flops per
// (query, key) pair on O(S hd) elements, far above the H100's ~295 flops
// per byte, so arithmetic bounds it: 68.75 GFLOP at the training shape
// (B 4, S 2048, nh 16, hd 128, causal), 0.0695 ms at 989 TFLOP/s bf16.
//
// bfloat16: flash_fwd_tc_kernel, on the tensor cores (tc_common.cuh).
// One block of two warpgroups per (batch * head, tile of 128 query rows),
// each warpgroup owning 64 rows; the query tiles are launched heaviest
// (last, under the causal diagonal) first.  Q stays bf16 in shared memory
// for the whole walk; K and V tiles of 64 keys come in by 16-byte cp.async
// into a two-stage ring, so that tile j + 1 is in flight while tile j is
// multiplied.  S = Q K^T and O += P V run on wgmma (m64n64k16, fp32
// accumulation); P is rounded to bf16 in registers, as the TPU kernel
// casts p to v's type, and fed as the register A operand.  The softmax
// state (row max, row sum) lives in registers, reduced over the four lanes
// that share a row; exp2 with log2(e) / sqrt(hd) folded into one multiply.
// Masks run only on the tiles that need them (the causal diagonal, the
// ragged end, a kv mask); tiles above the diagonal are skipped.  With
// dropout, O sums the kept p and 1 / keep_p is folded into the final
// 1 / l.
//
// float32: flash_fwd_kernel, fp32 FMAs on the CUDA cores over the 64 x 64
// tile loop of attention_common.cuh.  It is the precision reference of the
// fp32 card-against-CPU checks; TF32 tensor cores would not hold their
// tolerances.
#include "attention_common.cuh"
#include "tc_common.cuh"

namespace ptt {

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, const int* __restrict__ mask,
                     int Sq, int Sk, int nh, int nkv, int causal,
                     float scale, Dropout drop) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TileSmem<D>& sm = *reinterpret_cast<TileSmem<D>*>(smem_raw);
  const int q0 = blockIdx.x * kTile;
  const int bh = blockIdx.y;
  const int b = bh / nh, h = bh % nh, hk = h / (nh / nkv);
  const int offset = Sk - Sq;
  if (threadIdx.x < kTile) {
    const int qp = q0 + threadIdx.x;
    sm.qoff[threadIdx.x] =
        qp < Sq ? ((long long)(b * (long long)Sq + qp) * nh + h) * D : -1;
  }
  init_tile<float, D>(sm, q);

  const int q_last = min(q0 + kTile, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + offset + 1) : Sk;
  auto key_off = [=](int kp) -> long long {
    const long long row = b * (long long)Sk + kp;
    if (mask != nullptr && mask[row] == 0) return -1;
    return (row * nkv + hk) * D;
  };
  auto valid = [=](int r, int kp) -> bool {
    return !causal || kp <= q0 + r + offset;
  };
  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
  // drop.word comes in as the seed; this (batch, head)'s word mixes in bh
  drop.word = dropout_word(drop.word, bh);
  drop.row0 = q0;
  attend_tile<float, D>(sm, k, v, k_end, scale, key_off, valid, acc, drop);
  finish_tile<float, D>(sm, out, lse + (long long)bh * Sq + q0, acc);
}

template <int D>
cudaError_t launch_flash(const void* q, const void* k, const void* v,
                         void* out, float* lse, const int* mask, int B,
                         int Sq, int Sk, int nh, int nkv, int causal,
                         Dropout drop, cudaStream_t stream) {
  const size_t smem = tile_smem_bytes<D>();
  auto kernel = flash_fwd_kernel<D>;
  static const cudaError_t attr = allow_smem(kernel, smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((Sq + kTile - 1) / kTile, B * nh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, mask, Sq,
      Sk, nh,
      nkv, causal, 1.0f / sqrtf((float)D), drop);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores
// ---------------------------------------------------------------------------
constexpr int kTcRows = 128;     // query rows per block: two warpgroups
constexpr int kTcKeys = tc::kKeys;
constexpr int kTcThreads = 256;

// Shared memory of flash_fwd_tc_kernel, bytes from the 1024-aligned base:
// Q [D/64][128][64], then two stages of K [D/64][64][64] and V (all
// SW128), then the two stages' key-valid flags.
template <int D>
struct FwdTcSmem {
  static constexpr int q = 0;
  static constexpr int kv_stage = D * kTcKeys * 2;  // one K or V tile
  static constexpr int k = q + D * kTcRows * 2;
  static constexpr int v = k + 2 * kv_stage;
  static constexpr int kok = v + 2 * kv_stage;
  static constexpr int bytes = kok + 2 * kTcKeys * 4 + tc::kGroupBytes;
};

// Blocks per SM the register budget is cut for: two at hd 64 and 128
// (128 registers a thread, no spills; the two blocks' warpgroups overlap
// one another's softmax with their products), one at hd 256.
constexpr int fwd_tc_min_blocks(int D) { return D <= 128 ? 2 : 1; }

template <int D>
__global__ void __launch_bounds__(kTcThreads, fwd_tc_min_blocks(D))
    flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        __nv_bfloat16* __restrict__ out,
                        float* __restrict__ lse, const int* __restrict__ mask,
                        int Sq, int Sk, int nh, int nkv, int causal,
                        float scale_log2, Dropout drop) {
  using S = FwdTcSmem<D>;
  constexpr int NB = D / 64;  // 64-column blocks of hd
  extern __shared__ __align__(16) unsigned char tc_smem[];
  unsigned char* base = tc::align1024(tc_smem);
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcRows;  // heaviest first
  const int b = bh / nh, h = bh % nh, hk = h / (nh / nkv);
  const int offset = Sk - Sq;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wrow = wg * 64 + ((tid >> 5) & 3) * 16 + g;  // row in block
  const int row[2] = {q0 + wrow, q0 + wrow + 8};
  const int wg_first = q0 + wg * 64;
  const int wg_last = min(wg_first + 63, Sq - 1);
  const int wg_kend = causal ? min(Sk, wg_last + offset + 1) : Sk;
  const int q_last = min(q0 + kTcRows, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + offset + 1) : Sk;
  const int n_tiles = k_end > 0 ? (k_end + kTcKeys - 1) / kTcKeys : 0;
  drop.word = dropout_word(drop.word, bh);
  auto load_kv = [&](int st, int k0) {
    tc::load_kv_tile<D, kTcThreads>(
        tc::smem_addr(base + S::k + st * S::kv_stage),
        tc::smem_addr(base + S::v + st * S::kv_stage),
        reinterpret_cast<int*>(base + S::kok) + st * kTcKeys, k, v, mask, b,
        Sk, nkv, hk, k0);
  };

  if (n_tiles > 0) {
    tc::load_tile<D, kTcThreads>(
        tc::smem_addr(base + S::q), q, kTcRows, [=](int r) -> long long {
          const int qp = q0 + r;
          return qp < Sq ? ((b * (long long)Sq + qp) * nh + h) * D : -1;
        });
    load_kv(0, 0);
    tc::cp_async_commit();
  }

  float o[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[nb][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const uint32_t qa = tc::smem_addr(base + S::q) + wg * 64 * tc::kRowBytes;

  for (int j = 0; j < n_tiles; ++j) {
    tc::cp_async_wait_all();
    __syncthreads();  // tile j landed; every warpgroup is done with j - 1
    if (j + 1 < n_tiles) {
      load_kv((j + 1) & 1, (j + 1) * kTcKeys);
      tc::cp_async_commit();
    }
    const int st = j & 1, k0 = j * kTcKeys;
    // a warpgroup whose rows see no key of this tile skips it (p = 0)
    if (wg_first > wg_last || k0 >= wg_kend) continue;
    const uint32_t ka = tc::smem_addr(base + S::k + st * S::kv_stage);
    const uint32_t va = tc::smem_addr(base + S::v + st * S::kv_stage);

    float s[32];
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t cb = (kk >> 2), ko = (kk & 3) * 32;
      tc::wgmma_ss(s, tc::desc(qa + cb * kTcRows * tc::kRowBytes + ko),
                   tc::desc(ka + cb * kTcKeys * tc::kRowBytes + ko), kk > 0);
    }
    tc::wgmma_commit();
    tc::wgmma_wait_all();
    tc::fence_regs(s);

    const bool need_mask = mask != nullptr || k0 + kTcKeys > Sk ||
                           (causal && k0 + kTcKeys - 1 > wg_first + offset);
    if (need_mask) {
      const int* kok = reinterpret_cast<const int*>(base + S::kok) +
                       st * kTcKeys;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = tc::acc_col(i, t);
        const bool ok = kok[c] &&
                        (!causal || k0 + c <= row[(i >> 1) & 1] + offset);
        if (!ok) s[i] = -INFINITY;
      }
    }
    // online softmax: rows g and g + 8 of this warp, 16 scores each per
    // lane, the row's four lanes reduced with shuffles
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float ms[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // a row with no valid key yet keeps m = -inf: shift by 0, p = 0
      ms[r] = mx[r] == -INFINITY ? 0.f : mx[r] * scale_log2;
      alpha[r] = tc::fast_exp2(m[r] * scale_log2 - ms[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      float p = tc::fast_exp2(fmaf(s[i], scale_log2, -ms[r]));
      rs[r] += p;
      if (drop.on && !dropout_keep(drop.word, drop.thresh, row[r],
                                   k0 + tc::acc_col(i, t)))
        p = 0.f;
      s[i] = p;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[nb][i] *= alpha[(i >> 1) & 1];

    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) tc::acc_to_a(s, kk, pa[kk]);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        tc::wgmma_rs_t(o[nb], pa[kk],
                       tc::desc(va + nb * kTcKeys * tc::kRowBytes +
                                kk * 16 * tc::kRowBytes));
    tc::wgmma_commit();
    tc::wgmma_wait_all();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) tc::fence_regs(o[nb]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) tc::fence_regs(pa[kk]);
  }

  // out = O / (l keep_p) (l == 0: zeros), lse = m scale + log(l) (l == 0:
  // -1e30), rows past Sq not written
  const float keep_p = drop.on ? drop.keep_p : 1.f;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = l[r] > 0.f ? 1.f / (l[r] * keep_p) : 0.f;
    if (t == 0 && row[r] < Sq)
      lse[(long long)bh * Sq + row[r]] =
          l[r] > 0.f ? (m[r] * scale_log2 + log2f(l[r])) * 0.69314718055994531f
                     : kMaskedInit;
  }
  tc::store_rows(out, o, row, inv, Sq, b, nh, h, t);
}

template <int D>
cudaError_t launch_flash_tc(const void* q, const void* k, const void* v,
                            void* out, float* lse, const int* mask, int B,
                            int Sq, int Sk, int nh, int nkv, int causal,
                            Dropout drop, cudaStream_t stream) {
  const size_t smem = FwdTcSmem<D>::bytes;
  auto kernel = flash_fwd_tc_kernel<D>;
  static const cudaError_t attr = allow_smem(kernel, smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid(B * nh, (Sq + kTcRows - 1) / kTcRows);
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), lse, mask, Sq, Sk, nh, nkv, causal,
      1.4426950408889634f / sqrtf((float)D), drop);
  return cudaGetLastError();
}

cudaError_t dispatch_flash_f32(int hd, const void* q, const void* k,
                               const void* v, void* out, float* lse,
                               const int* mask, int B, int Sq, int Sk,
                               int nh, int nkv, int causal, Dropout drop,
                               cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch_flash<64>(q, k, v, out, lse, mask, B, Sq, Sk, nh,
                                     nkv, causal, drop, stream);
    case 128:
      return launch_flash<128>(q, k, v, out, lse, mask, B, Sq, Sk,
                                      nh, nkv, causal, drop, stream);
    case 256:
      return launch_flash<256>(q, k, v, out, lse, mask, B, Sq, Sk,
                                      nh, nkv, causal, drop, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// bf16 takes the tensor-core kernel or nothing: an hd it does not take
// raises, it never drops to the FMA kernel
cudaError_t dispatch_flash_bf16(int hd, const void* q, const void* k,
                                const void* v, void* out, float* lse,
                                const int* mask, int B, int Sq, int Sk,
                                int nh, int nkv, int causal, Dropout drop,
                                cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch_flash_tc<64>(q, k, v, out, lse, mask, B, Sq, Sk, nh, nkv,
                                 causal, drop, stream);
    case 128:
      return launch_flash_tc<128>(q, k, v, out, lse, mask, B, Sq, Sk, nh,
                                  nkv, causal, drop, stream);
    case 256:
      return launch_flash_tc<256>(q, k, v, out, lse, mask, B, Sq, Sk, nh,
                                  nkv, causal, drop, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace ptt

// q [B, Sq, nh, hd], k/v [B, Sk, nkv, hd], out like q, lse [B, nh, Sq]
// fp32; all contiguous on the device.  mask: [B, Sk] int32 or null.
// dtype: 0 = float32 (FMA kernel), 1 = bfloat16 (tensor-core kernel).
// Dropout is on when thresh > 0: keep when the bits of (seed, bh, row,
// col) are below thresh, kept p / keep_p.  Returns the cudaError_t of the
// launch (0 = success).
extern "C" int ptt_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, const void* mask, int B,
                             int Sq, int Sk, int nh, int nkv, int hd,
                             int causal, int dtype, unsigned seed,
                             unsigned thresh, float keep_p, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || nkv <= 0 || nh % nkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const int* m = static_cast<const int*>(mask);
  ptt::Dropout drop;
  drop.word = seed;
  drop.thresh = thresh;
  drop.keep_p = keep_p;
  drop.on = thresh > 0;
  cudaError_t err =
      dtype == 1   ? ptt::dispatch_flash_bf16(hd, q, k, v, out, l, m, B, Sq,
                                              Sk, nh, nkv, causal, drop, s)
      : dtype == 0 ? ptt::dispatch_flash_f32(hd, q, k, v, out, l, m, B, Sq,
                                             Sk, nh, nkv, causal, drop, s)
                   : cudaErrorInvalidValue;
  return (int)err;
}
