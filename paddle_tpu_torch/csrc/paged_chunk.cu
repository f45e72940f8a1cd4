// Chunked-prefill attention over the paged KV pool for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_chunk_grid_kernel` and
// `_chunk_fused_kernel` in paddle_tpu/ops/pallas_paged.py:229 and :284
// (one pallas_call, :413; driven by `paged_chunk_attention`, and by
// `paged_verify_attention` for spec verify).  The two Pallas kernels are
// two layouts of one function, chosen by the TPU interpreter's cost model;
// on the card it is one function too, in two kernels by type.
//
// Computes, for chunk queries q [B, s, nh, hd] sitting at absolute
// positions start[b] + j, against the pools [nh, num_blocks, bs, hd]
// read through the block table [B, max_blocks]:
//   out[b, j, h] = softmax over keys kpos <= start[b] + j of q k^T / sqrt(hd)
// The chunk's own keys are already in the pool (the caller's scatter wrote
// them).  Keys stop at the end of the table, so a query row past it (the
// overflow rows of a padded last chunk) attends the whole table; the
// caller discards those rows.  A key whose table entry lies outside the
// pool is dropped, never read, as paged_decode.cu and the plain versions
// drop it; a row with no key left writes zeros.  Rows past s are not
// written.
//
// What bounds it: a chunk's rows against the cached prefix do 4 hd flops
// per (row, key) pair on 2 hd pool elements per key, read once.  At the
// serving path's shape (B 1, s 256, start 1024, nh 16, hd 128, bf16) that
// is 2.42 GFLOP on 12.6 MB: 0.0024 ms of bf16 tensor-core time at 989
// TFLOP/s against 0.0038 ms of memory time at 3.35 TB/s, so the bound is
// the bytes.  But at B 1 the real limit is how many SMs are busy: one
// block per (sequence x head, 128 query rows) is 32 blocks for the card's
// 132 SMs, each walking ~1200 keys in order.
//
// bfloat16: paged_chunk_tc_kernel, on the tensor cores, built from
// tc_common.cuh like flash_fwd.cu's flash_fwd_tc_kernel, which it follows:
// one block of two warpgroups (64 query rows each) per (sequence x head,
// 128 rows, split of the key axis); Q bf16 SW128 in shared memory; K and V
// tiles of 64 keys by 16-byte cp.async into a two-stage ring; S = Q K^T
// and O += P V on wgmma (m64n64k16, fp32 accumulation), P rounded to bf16
// in registers (the TPU kernel casts p to v's type); the softmax state in
// registers with exp2.  Two changes from the forward: key row kp comes from
// pool block table[kp / bs], row kp % bs (the block's slice of the table
// row staged in shared memory once), and the causal offset is start[b].
// Only the tiles that need it are masked (the diagonal, the table's end,
// a tile with a dropped key: a warp vote on the tile's key flags), and the
// tiles above the diagonal are skipped.
//
// The split.  To fill the card at B 1 the key axis is cut into splits of
// keys_per_split keys (ops/paged_attention.py `chunk_split` picks them
// from the shapes alone, never from the starts, which live on the card).
// Each split writes its partial state (O unnormalised, m, l in fp32) to a
// workspace, and paged_chunk_merge_kernel combines a row's splits by their
// maxima in split order; a split past a row's keys writes (m -inf, l 0)
// and the merge skips it.  With one split the kernel normalises and writes
// out itself, and no merge runs.
//
// float32: paged_chunk_kernel, fp32 FMAs on the CUDA cores over the 64 x 64
// tile loop of attention_common.cuh (one block of 256 threads per
// (sequence x head, 64 rows)); it is the precision reference of the fp32
// card-against-CPU checks, which TF32 would not hold.
#include "attention_common.cuh"
#include "tc_common.cuh"

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

template <int D>
cudaError_t launch_chunk(const void* q, const void* k_pool,
                         const void* v_pool, const int* tables,
                         const int* starts, void* out, int B, int s, int nh,
                         int num_blocks, int bs, int max_blocks,
                         cudaStream_t stream) {
  const size_t smem = tile_smem_bytes<D>();
  auto kernel = paged_chunk_kernel<float, D>;
  static const cudaError_t attr = allow_smem(kernel, smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((s + kTile - 1) / kTile, B * nh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k_pool),
      static_cast<const float*>(v_pool), tables, starts,
      static_cast<float*>(out), s, nh, num_blocks, bs, max_blocks,
      1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

cudaError_t dispatch_chunk_f32(int hd, const void* q, const void* k_pool,
                               const void* v_pool, const int* tables,
                               const int* starts, void* out, int B, int s,
                               int nh, int num_blocks, int bs, int max_blocks,
                               cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch_chunk<64>(q, k_pool, v_pool, tables, starts, out, B, s,
                              nh, num_blocks, bs, max_blocks, stream);
    case 128:
      return launch_chunk<128>(q, k_pool, v_pool, tables, starts, out, B, s,
                               nh, num_blocks, bs, max_blocks, stream);
    case 256:
      return launch_chunk<256>(q, k_pool, v_pool, tables, starts, out, B, s,
                               nh, num_blocks, bs, max_blocks, stream);
    default:
      return cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores
// ---------------------------------------------------------------------------
constexpr int kChunkRows = 128;    // query rows per block: two warpgroups
constexpr int kChunkKeys = tc::kKeys;
constexpr int kChunkThreads = 256;
constexpr int kMaxSmem = 232448;   // the most shared memory a block may ask

// Shared memory of paged_chunk_tc_kernel, bytes from the 1024-aligned
// base: Q [D/64][128][64], two stages of K [D/64][64][64] and V (all
// SW128), the two stages' key-valid flags, then the split's slice of the
// table row (n_tab entries, sized at launch).
template <int D>
struct ChunkTcSmem {
  static constexpr int kv_stage = D * kChunkKeys * 2;  // one K or V tile
  static constexpr int q = 0;
  static constexpr int k = q + D * kChunkRows * 2;
  static constexpr int v = k + 2 * kv_stage;
  static constexpr int kok = v + 2 * kv_stage;
  static constexpr int table = kok + 2 * kChunkKeys * 4;
  static size_t bytes(int n_tab) {
    return table + (size_t)n_tab * 4 + tc::kGroupBytes;
  }
};

// Two blocks per SM at hd 64 and 128 (128 registers a thread), one at 256.
constexpr int chunk_tc_min_blocks(int D) { return D <= 128 ? 2 : 1; }

template <int D>
__global__ void __launch_bounds__(kChunkThreads, chunk_tc_min_blocks(D))
    paged_chunk_tc_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k_pool,
                          const __nv_bfloat16* __restrict__ v_pool,
                          const int* __restrict__ tables,
                          const int* __restrict__ starts,
                          __nv_bfloat16* __restrict__ out,
                          float* __restrict__ work, int s, int nh,
                          int num_blocks, int bs, int max_blocks,
                          int keys_per_split, float scale_log2) {
  using S = ChunkTcSmem<D>;
  constexpr int NB = D / 64;  // 64-column blocks of hd
  constexpr int C = D / 8;    // 16-byte chunks of a key row
  extern __shared__ __align__(16) unsigned char tc_smem[];
  unsigned char* base = tc::align1024(tc_smem);
  const int bh = blockIdx.x, split = blockIdx.z, n_split = gridDim.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kChunkRows;  // heaviest first
  const int b = bh / nh, h = bh % nh;
  const int start = starts[b];
  const int tid = threadIdx.x, wg = tid >> 7;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wrow = wg * 64 + ((tid >> 5) & 3) * 16 + g;  // row in block
  const int row[2] = {q0 + wrow, q0 + wrow + 8};
  const int table_keys = max_blocks * bs;
  const int wg_first = q0 + wg * 64;
  const int wg_last = min(wg_first + 63, s - 1);
  const int wg_kend = min(start + wg_last + 1, table_keys);
  const int q_last = min(q0 + kChunkRows, s) - 1;
  // this block's keys: its split of the keys its rows see
  const int k_lo = split * keys_per_split;
  const int k_hi = min(min(start + q_last + 1, table_keys),
                       k_lo + keys_per_split);
  const int n_tiles =
      k_hi > k_lo ? (k_hi - k_lo + kChunkKeys - 1) / kChunkKeys : 0;
  int* tab = reinterpret_cast<int*>(base + S::table);
  const int tab0 = k_lo / bs;

  if (n_tiles > 0) {
    const int* trow = tables + (long long)b * max_blocks + tab0;
    for (int i = tid; i <= (k_hi - 1) / bs - tab0; i += kChunkThreads)
      tab[i] = trow[i];
  }
  __syncthreads();  // the table slice before the first key tile's load

  // Key tile k0 .. k0 + 63 into stage st: key kp from pool block
  // tab[kp / bs - tab0], row kp % bs; a key past the block's keys or with
  // an entry outside the pool is zeros and flag 0, and is never read.
  auto load_kv = [&](int st, int k0) {
    const uint32_t kd = tc::smem_addr(base + S::k + st * S::kv_stage);
    const uint32_t vd = tc::smem_addr(base + S::v + st * S::kv_stage);
    int* kok = reinterpret_cast<int*>(base + S::kok) + st * kChunkKeys;
    for (int idx = tid; idx < kChunkKeys * C; idx += kChunkThreads) {
      const int r = idx / C, c = idx % C;
      const int kp = k0 + r;
      long long o = -1;
      if (kp < k_hi) {
        const int blk = tab[kp / bs - tab0];
        if (blk >= 0 && blk < num_blocks)
          o = (((long long)h * num_blocks + blk) * bs + kp % bs) * D;
      }
      const uint32_t so = tc::sw128_offset(r, c, kChunkKeys);
      tc::cp_async16(kd + so, o >= 0 ? k_pool + o + c * 8 : k_pool,
                     o >= 0 ? 16 : 0);
      tc::cp_async16(vd + so, o >= 0 ? v_pool + o + c * 8 : v_pool,
                     o >= 0 ? 16 : 0);
      if (c == 0) kok[r] = o >= 0;
    }
  };

  if (n_tiles > 0) {
    tc::load_tile<D, kChunkThreads>(
        tc::smem_addr(base + S::q), q, kChunkRows, [=](int r) -> long long {
          const int qp = q0 + r;
          return qp < s ? ((b * (long long)s + qp) * nh + h) * D : -1;
        });
    load_kv(0, k_lo);
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
      load_kv((j + 1) & 1, k_lo + (j + 1) * kChunkKeys);
      tc::cp_async_commit();
    }
    const int st = j & 1, k0 = k_lo + j * kChunkKeys;
    // a warpgroup whose rows see no key of this tile skips it (p = 0)
    if (wg_first > wg_last || k0 >= wg_kend) continue;
    const uint32_t ka = tc::smem_addr(base + S::k + st * S::kv_stage);
    const uint32_t va = tc::smem_addr(base + S::v + st * S::kv_stage);
    const int* kok = reinterpret_cast<const int*>(base + S::kok) +
                     st * kChunkKeys;

    float sc[32];
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t cb = (kk >> 2), ko = (kk & 3) * 32;
      tc::wgmma_ss(sc, tc::desc(qa + cb * kChunkRows * tc::kRowBytes + ko),
                   tc::desc(ka + cb * kChunkKeys * tc::kRowBytes + ko),
                   kk > 0);
    }
    tc::wgmma_commit();
    tc::wgmma_wait_all();
    tc::fence_regs(sc);

    // the diagonal, or a key of the tile dropped or past the keys
    const bool dropped = __any_sync(0xffffffffu,
                                    !kok[lane] || !kok[lane + 32]);
    if (dropped || k0 + kChunkKeys - 1 > wg_first + start) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = tc::acc_col(i, t);
        if (!kok[c] || k0 + c > row[(i >> 1) & 1] + start)
          sc[i] = -INFINITY;
      }
    }
    // online softmax: rows g and g + 8 of this warp, 16 scores each per
    // lane, the row's four lanes reduced with shuffles
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
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
      const float p = tc::fast_exp2(fmaf(sc[i], scale_log2, -ms[r]));
      rs[r] += p;
      sc[i] = p;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[nb][i] *= alpha[(i >> 1) & 1];

    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) tc::acc_to_a(sc, kk, pa[kk]);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        tc::wgmma_rs_t(o[nb], pa[kk],
                       tc::desc(va + nb * kChunkKeys * tc::kRowBytes +
                                kk * 16 * tc::kRowBytes));
    tc::wgmma_commit();
    tc::wgmma_wait_all();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) tc::fence_regs(o[nb]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) tc::fence_regs(pa[kk]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (n_split == 1) {
    // out = O / l (l == 0: zeros), rows past s not written
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
    tc::store_rows(out, o, row, inv, s, b, nh, h, t);
    return;
  }
  // the split's partial state: acc [n_split][B nh][s][D], then (m in log2
  // units, l) [n_split][B nh][s]; a row with no key here writes (-inf, 0)
  const long long part = (long long)split * gridDim.x + bh;
  float2* ml = reinterpret_cast<float2*>(
                   work + (long long)n_split * gridDim.x * s * D) +
               part * s;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= s) continue;
    if (t == 0)
      ml[row[r]] = make_float2(l[r] > 0.f ? m[r] * scale_log2 : -INFINITY,
                               l[r]);
    if (l[r] == 0.f) continue;
    float* dst = work + (part * s + row[r]) * D;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        *reinterpret_cast<float2*>(dst + nb * 64 + jj * 8 + 2 * t) =
            make_float2(o[nb][4 * jj + 2 * r], o[nb][4 * jj + 2 * r + 1]);
  }
}

// One thread per 4 columns of a row: a row's splits merged by their maxima
// in split order (deterministic); an empty split (m = -inf) weighs 0 and
// its acc is never read; out = sum w acc / sum w l, zeros where no split
// saw a key.
template <int D>
__global__ void __launch_bounds__(kChunkThreads)
    paged_chunk_merge_kernel(const float* __restrict__ work,
                             __nv_bfloat16* __restrict__ out, int s, int nh,
                             int n_split) {
  constexpr int kPerRow = D / 4;                 // threads per row
  constexpr int kRows = kChunkThreads / kPerRow;  // rows per block
  const int bh = blockIdx.y, BH = gridDim.y;
  const int r = blockIdx.x * kRows + threadIdx.x / kPerRow;
  const int c = (threadIdx.x % kPerRow) * 4;
  if (r >= s) return;
  const float2* ml =
      reinterpret_cast<const float2*>(work + (long long)n_split * BH * s * D);
  float mall = -INFINITY;
  for (int sp = 0; sp < n_split; ++sp)
    mall = fmaxf(mall, ml[((long long)sp * BH + bh) * s + r].x);
  float lall = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int sp = 0; sp < n_split; ++sp) {
    const long long part = ((long long)sp * BH + bh) * s + r;
    const float2 st = ml[part];
    if (st.x == -INFINITY) continue;
    const float w = exp2f(st.x - mall);
    lall = fmaf(w, st.y, lall);
    const float4 a = *reinterpret_cast<const float4*>(work + part * D + c);
    acc[0] = fmaf(w, a.x, acc[0]);
    acc[1] = fmaf(w, a.y, acc[1]);
    acc[2] = fmaf(w, a.z, acc[2]);
    acc[3] = fmaf(w, a.w, acc[3]);
  }
  const float inv = lall > 0.f ? 1.f / lall : 0.f;
  uint2 packed;
  packed.x = tc::pack_bf16(acc[0] * inv, acc[1] * inv);
  packed.y = tc::pack_bf16(acc[2] * inv, acc[3] * inv);
  *reinterpret_cast<uint2*>(
      out + (((long long)(bh / nh) * s + r) * nh + bh % nh) * D + c) = packed;
}

template <int D>
cudaError_t launch_chunk_tc(const void* q, const void* k_pool,
                            const void* v_pool, const int* tables,
                            const int* starts, void* out, float* work, int B,
                            int s, int nh, int num_blocks, int bs,
                            int max_blocks, int keys_per_split,
                            cudaStream_t stream) {
  if (keys_per_split <= 0 || keys_per_split % kChunkKeys != 0)
    return cudaErrorInvalidValue;
  const long long table_keys = (long long)max_blocks * bs;
  const int n_split =
      (int)((table_keys + keys_per_split - 1) / keys_per_split);
  const size_t smem = ChunkTcSmem<D>::bytes(keys_per_split / bs + 2);
  if (smem > (size_t)kMaxSmem || n_split > 65535 ||
      (n_split > 1 && work == nullptr))
    return cudaErrorInvalidValue;
  auto kernel = paged_chunk_tc_kernel<D>;
  static const cudaError_t attr = allow_smem(kernel, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(k_pool);
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(v_pool);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  dim3 grid(B * nh, (s + kChunkRows - 1) / kChunkRows, n_split);
  kernel<<<grid, kChunkThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), kp, vp, tables, starts, o, work,
      s, nh, num_blocks, bs, max_blocks, keys_per_split,
      1.4426950408889634f / sqrtf((float)D));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  constexpr int kRows = kChunkThreads / (D / 4);
  paged_chunk_merge_kernel<D>
      <<<dim3((s + kRows - 1) / kRows, B * nh), kChunkThreads, 0, stream>>>(
          work, o, s, nh, n_split);
  return cudaGetLastError();
}

// bf16 takes the tensor-core kernel or nothing: an hd it does not take
// raises, it never drops to the FMA kernel
cudaError_t dispatch_chunk_bf16(int hd, const void* q, const void* k_pool,
                                const void* v_pool, const int* tables,
                                const int* starts, void* out, float* work,
                                int B, int s, int nh, int num_blocks, int bs,
                                int max_blocks, int keys_per_split,
                                cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch_chunk_tc<64>(q, k_pool, v_pool, tables, starts, out,
                                 work, B, s, nh, num_blocks, bs, max_blocks,
                                 keys_per_split, stream);
    case 128:
      return launch_chunk_tc<128>(q, k_pool, v_pool, tables, starts, out,
                                  work, B, s, nh, num_blocks, bs, max_blocks,
                                  keys_per_split, stream);
    case 256:
      return launch_chunk_tc<256>(q, k_pool, v_pool, tables, starts, out,
                                  work, B, s, nh, num_blocks, bs, max_blocks,
                                  keys_per_split, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace ptt

// q [B, s, nh, hd], pools [nh, num_blocks, bs, hd], tables [B, max_blocks]
// int32, starts [B] int32, out like q; all contiguous on the device.
// dtype: 0 = float32 (FMA kernel), 1 = bfloat16 (tensor-core kernel).
// bfloat16 only: the key axis in splits of keys_per_split keys (a multiple
// of 64), and work, fp32 scratch of n_split * B * nh * s * (hd + 2) floats
// for n_split = ceil(max_blocks * bs / keys_per_split) > 1 (null for one
// split).  Returns the launches' cudaError_t.
extern "C" int ptt_paged_chunk(const void* q, const void* k_pool,
                               const void* v_pool, const void* tables,
                               const void* starts, void* out, void* work,
                               int B, int s, int nh, int hd, int num_blocks,
                               int bs, int max_blocks, int keys_per_split,
                               int dtype, void* stream) {
  if (B <= 0 || s <= 0 || bs <= 0 || max_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tables);
  const int* st0 = static_cast<const int*>(starts);
  cudaError_t err =
      dtype == 1 ? ptt::dispatch_chunk_bf16(
                       hd, q, k_pool, v_pool, t, st0, out,
                       static_cast<float*>(work), B, s, nh, num_blocks, bs,
                       max_blocks, keys_per_split, st)
      : dtype == 0 ? ptt::dispatch_chunk_f32(hd, q, k_pool, v_pool, t, st0,
                                             out, B, s, nh, num_blocks, bs,
                                             max_blocks, st)
                   : cudaErrorInvalidValue;
  return (int)err;
}
