// FlashAttention forward for Hopper (sm_90a), plain FMA on CUDA cores.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` in
// paddle_tpu/ops/pallas_flash.py (driven by `flash_attention_fwd`): the
// whole-prompt prefill attention of the serving engine, and the forward of
// the training step's attention (ops/flash_attention.py FlashAttention).
//
// Computes, for q [B, Sq, nh, hd] against k, v [B, Sk, nkv, hd] (nh a
// multiple of nkv: grouped-query attention reads kv head h / (nh / nkv)),
//   out[b, i, h] = softmax(q k^T / sqrt(hd)) v        (fp32 accumulation)
//   lse[b, h, i] = log-sum-exp of the scaled scores   (fp32)
// with the end-aligned causal mask key <= i + (Sk - Sq) when causal.
// Any Sq and Sk: the ragged last tiles are masked, never padded by the
// caller.  An optional key mask [B, Sk] int32 (0 = padded key) drops keys
// as if they were not there: their offset is -1, so they are never read
// and score -inf (p = 0 even in a row that is fully masked, whose m stays
// at -1e30).  Dropout (attention_common.cuh) drops the normalised
// probabilities: l sums the undropped p, the output the dropped ones.
//
// Layout on the card: one block of 256 threads per (batch * head, tile of
// 64 query rows).  The TPU kernel walks key blocks as its last, sequential
// grid dimension with the softmax state in VMEM; here that walk is a loop
// inside the block, with the state in shared memory and registers.
//
// What bounds it: at prefill lengths (S >= 128) attention does
// ~4 S^2 hd / 2 flops on ~4 S hd elements, far above the H100's ~295
// flops per byte, so it is bounded by arithmetic.  This first version
// computes with fp32 FMAs (67 TFLOP/s peak), not the tensor cores
// (989 TFLOP/s bf16), so it cannot reach the bound; what it does do is
// keep the S x S score matrix out of device memory, stage each K/V tile
// in shared memory once for 64 query rows, and skip key tiles above the
// causal diagonal.  wgmma + TMA is the later step.
#include "attention_common.cuh"

namespace ptt {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
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
  init_tile<T, D>(sm, q);

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
  attend_tile<T, D>(sm, k, v, k_end, scale, key_off, valid, acc, drop);
  finish_tile<T, D>(sm, out, lse + (long long)bh * Sq + q0, acc);
}

template <typename T, int D>
cudaError_t launch_flash(const void* q, const void* k, const void* v,
                         void* out, float* lse, const int* mask, int B,
                         int Sq, int Sk, int nh, int nkv, int causal,
                         Dropout drop, cudaStream_t stream) {
  const size_t smem = tile_smem_bytes<D>();
  auto kernel = flash_fwd_kernel<T, D>;
  static const cudaError_t attr = allow_smem(kernel, smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((Sq + kTile - 1) / kTile, B * nh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, mask, Sq, Sk, nh,
      nkv, causal, 1.0f / sqrtf((float)D), drop);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_flash(int hd, const void* q, const void* k,
                           const void* v, void* out, float* lse,
                           const int* mask, int B, int Sq, int Sk, int nh,
                           int nkv, int causal, Dropout drop,
                           cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch_flash<T, 64>(q, k, v, out, lse, mask, B, Sq, Sk, nh,
                                 nkv, causal, drop, stream);
    case 128:
      return launch_flash<T, 128>(q, k, v, out, lse, mask, B, Sq, Sk, nh,
                                  nkv, causal, drop, stream);
    case 256:
      return launch_flash<T, 256>(q, k, v, out, lse, mask, B, Sq, Sk, nh,
                                  nkv, causal, drop, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace ptt

// q [B, Sq, nh, hd], k/v [B, Sk, nkv, hd], out like q, lse [B, nh, Sq]
// fp32; all contiguous on the device.  mask: [B, Sk] int32 or null.
// dtype: 0 = float32, 1 = bfloat16.  Dropout is on when thresh > 0: keep
// when the bits of (seed, bh, row, col) are below thresh, kept p / keep_p.
// Returns the cudaError_t of the launch (0 = success).
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
      dtype == 1
          ? ptt::dispatch_flash<__nv_bfloat16>(hd, q, k, v, out, l, m, B,
                                               Sq, Sk, nh, nkv, causal, drop,
                                               s)
      : dtype == 0 ? ptt::dispatch_flash<float>(hd, q, k, v, out, l, m, B,
                                                Sq, Sk, nh, nkv, causal,
                                                drop, s)
                   : cudaErrorInvalidValue;
  return (int)err;
}
