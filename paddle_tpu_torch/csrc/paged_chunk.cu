// Chunked-prefill attention over the paged KV pool for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_chunk_grid_kernel` and
// `_chunk_fused_kernel` in paddle_tpu/ops/pallas_paged.py (driven by
// `paged_chunk_attention`, and by `paged_verify_attention` for spec
// verify).  The two Pallas kernels are two layouts of one function, chosen
// by the TPU interpreter's cost model; on the card it is this one kernel.
//
// Computes, for chunk queries q [B, s, nh, hd] sitting at absolute
// positions start[b] + j, against the pools [nh, num_blocks, bs, hd]
// read through the block table [B, max_blocks]:
//   out[b, j, h] = softmax over keys kpos <= start[b] + j of q k^T / sqrt(hd)
// The chunk's own keys are already in the pool (the caller's scatter wrote
// them).  Keys stop at the end of the table, so a query row past it (the
// overflow rows of a padded last chunk) attends the whole table; the
// caller discards those rows.  A key whose table entry lies outside the
// pool is dropped, as paged_decode.cu and the plain versions drop it.
//
// Layout on the card: one block of 256 threads per (sequence * head, tile
// of 64 chunk rows).  The block reads its own table row and walks keys
// 0 .. min(start + last row + 1, max_blocks * bs) in steps of 64, each key
// row fetched from its pool block; the TPU kernel's sequential block
// dimension becomes this loop, its VMEM softmax state shared memory.
//
// What bounds it: a 256-row chunk against up to 2048 cached keys does
// ~4 * 256 * 2048 * hd flops on ~2 * 2048 * hd pool elements — far above
// the ~295 flops per byte where the H100's tensor cores take over from
// memory, so arithmetic bounds it.  Like flash_fwd.cu this first version
// uses fp32 FMAs (the shared tile loop in attention_common.cuh) rather
// than the tensor cores; it reads only the live prefix of the table and
// stages each K/V tile once per 64 query rows.
#include "attention_common.cuh"

namespace ptt {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    paged_chunk_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int* __restrict__ tables,
                       const int* __restrict__ starts, T* __restrict__ out,
                       int s, int nh, int num_blocks, int bs,
                       int max_blocks, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TileSmem<D>& sm = *reinterpret_cast<TileSmem<D>*>(smem_raw);
  const int q0 = blockIdx.x * kTile;
  const int bh = blockIdx.y;
  const int b = bh / nh, h = bh % nh;
  const int start = starts[b];
  const int* table = tables + (long long)b * max_blocks;
  if (threadIdx.x < kTile) {
    const int qp = q0 + threadIdx.x;
    sm.qoff[threadIdx.x] =
        qp < s ? ((long long)(b * (long long)s + qp) * nh + h) * D : -1;
  }
  init_tile<T, D>(sm, q);

  const int q_last = min(q0 + kTile, s) - 1;
  const int k_end = min(start + q_last + 1, max_blocks * bs);
  auto key_off = [=](int kp) -> long long {
    const int blk = table[kp / bs];
    if (blk < 0 || blk >= num_blocks) return -1;  // dropped, never read
    return (((long long)h * num_blocks + blk) * bs + kp % bs) * D;
  };
  auto valid = [=](int r, int kp) -> bool { return kp <= start + q0 + r; };
  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
  attend_tile<T, D>(sm, k_pool, v_pool, k_end, scale, key_off, valid, acc);
  finish_tile<T, D>(sm, out, nullptr, acc);
}

template <typename T, int D>
cudaError_t launch_chunk(const void* q, const void* k_pool,
                         const void* v_pool, const int* tables,
                         const int* starts, void* out, int B, int s, int nh,
                         int num_blocks, int bs, int max_blocks,
                         cudaStream_t stream) {
  const size_t smem = tile_smem_bytes<D>();
  auto kernel = paged_chunk_kernel<T, D>;
  static const cudaError_t attr = allow_smem(kernel, smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((s + kTile - 1) / kTile, B * nh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), tables, starts, static_cast<T*>(out), s,
      nh, num_blocks, bs, max_blocks, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_chunk(int hd, const void* q, const void* k_pool,
                           const void* v_pool, const int* tables,
                           const int* starts, void* out, int B, int s,
                           int nh, int num_blocks, int bs, int max_blocks,
                           cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch_chunk<T, 64>(q, k_pool, v_pool, tables, starts, out, B,
                                 s, nh, num_blocks, bs, max_blocks, stream);
    case 128:
      return launch_chunk<T, 128>(q, k_pool, v_pool, tables, starts, out, B,
                                  s, nh, num_blocks, bs, max_blocks, stream);
    case 256:
      return launch_chunk<T, 256>(q, k_pool, v_pool, tables, starts, out, B,
                                  s, nh, num_blocks, bs, max_blocks, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace ptt

// q [B, s, nh, hd], pools [nh, num_blocks, bs, hd], tables [B, max_blocks]
// int32, starts [B] int32, out like q; all contiguous on the device.
// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t.
extern "C" int ptt_paged_chunk(const void* q, const void* k_pool,
                               const void* v_pool, const void* tables,
                               const void* starts, void* out, int B, int s,
                               int nh, int hd, int num_blocks, int bs,
                               int max_blocks, int dtype, void* stream) {
  if (B <= 0 || s <= 0 || bs <= 0 || max_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tables);
  const int* st0 = static_cast<const int*>(starts);
  cudaError_t err =
      dtype == 1 ? ptt::dispatch_chunk<__nv_bfloat16>(
                       hd, q, k_pool, v_pool, t, st0, out, B, s, nh,
                       num_blocks, bs, max_blocks, st)
      : dtype == 0 ? ptt::dispatch_chunk<float>(hd, q, k_pool, v_pool, t,
                                                st0, out, B, s, nh,
                                                num_blocks, bs, max_blocks, st)
                   : cudaErrorInvalidValue;
  return (int)err;
}
