// FlashAttention backward for Hopper (sm_90a): flash_bwd_dq and
// flash_bwd_dkv.
//
// Replace the Pallas TPU kernels `_bwd_dq_kernel`
// (paddle_tpu/ops/pallas_flash.py:340) and `_bwd_dkv_kernel` (:403), driven
// by `_flash_bwd`: the backward of the training step's attention
// (ops/flash_attention.py FlashAttention).
//
// For q [B, Sq, nh, hd], k, v [B, Sk, nkv, hd], the forward's out and lse
// [B, nh, Sq] and the output gradient dO (like q), with the FlashAttention-2
// identities (never the S x S matrices in device memory):
//   p  = exp(q k^T * scale - lse)          0 on masked entries
//   D  = rowsum(dO * out)                  per query row
//   dp = dO v^T, dropped and / keep_p by the forward's keep bits
//   ds = p * (dp - D) * scale
//   dq = ds k                               flash_bwd_dq
//   dv = (keep ? p / keep_p : 0)^T dO,  dk = ds^T q      flash_bwd_dkv
// Masks are the forward's: end-aligned causal (key <= i + Sk - Sq), the
// optional key mask [B, Sk] int32, ragged tiles.  p is zeroed explicitly
// on every masked entry: a fully masked row has lse = -1e30, and a -1e30
// score would give exp(0) = 1 there.
//
// The TPU kernels walk their reduction axis as the last, sequential grid
// dimension with the sum in VMEM scratch; blocks on the card run in no
// order, so each walk is a loop inside one block with the sum in
// registers, written once (deterministic, no atomics).
//
// What bounds them: per (query, key) pair dq does 6 hd flops and dk/dv
// 8 hd on O(S hd) elements, far above the H100's ~295 flops per byte, so
// arithmetic bounds both: at the training shape (B 4, S 2048, nh 16, hd
// 128, causal) dq 103.1 GFLOP, 0.1043 ms, and dk/dv 137.5 GFLOP, 0.1390
// ms, at 989 TFLOP/s bf16.
//
// flash_bwd_dq, bfloat16 and float16: flash_bwd_dq_tc_kernel<T>, on the
// tensor cores (tc_common.cuh), the forward's machinery (T: bf16 or fp16;
// the two share every line but the products' type strings and the
// rounding of the A fragments).  One block of two warpgroups
// per (batch * head, tile of 128 query rows), heaviest tiles first; Q and
// dO stay T in shared memory, D and lse in registers; K and V tiles of
// 64 keys come in by cp.async, double-buffered (hd 256: one stage, for
// shared memory).  S = Q K^T and dP = dO V^T run on wgmma from shared
// memory; dS is rounded to T in registers, as the TPU kernel casts ds
// to k's type, and dQ += dS K runs on wgmma with dS as the register A
// operand and the K tile read transposed.
//
// flash_bwd_dkv, bfloat16 and float16: flash_bwd_dkv_tc_kernel<T>, on the
// tensor cores
// with the same machinery, key-stationary and transposed.  One block of
// two warpgroups per (batch * KV head, tile of 128 keys), each warpgroup
// owning 64 keys; key tiles are launched in ascending order, since under
// the causal mask key tile 0 is seen by every query and is the heaviest.
// The K and V tiles are loaded once and stay T (SW128) in shared
// memory.  The block loops over the query heads of its GQA group and, for
// each, over the query tiles of 64 rows from the causal diagonal on (a
// warpgroup skips the tiles none of whose rows sees its keys), summing dK
// and dV over the group in fp32 registers: no [B, nh, Sk, hd] buffer as
// on the TPU (pallas_flash.py:582-587).  The Q and dO tiles come in by
// cp.async, double-buffered (hd 256: one stage, for shared memory), with
// each row's lse and D.  Transposed products keep every intermediate in
// registers, each accumulator row a key and each column a query:
//   S^T = K Q^T,  dP^T = V dO^T       wgmma_ss (K/V tile A, Q/dO tile B)
//   P^T = exp2((S^T - lse / scale) scale log2 e), 0 on masked entries
//   dS^T = P^T (dP^T dropped - D) scale
//   dV += P_drop^T dO,  dK += dS^T Q   wgmma_rs_t (register A, the same
//                                      [query][d] tile read transposed)
// Masks run only on diagonal, ragged or kv-masked tiles.  Keys past Sk
// are never written; a key masked out by the kv mask, or one no query
// sees, is never read (zeros in shared memory) and gets dK = dV = 0.
// D = rowsum(dO * out) comes from a small pre-pass kernel in this file
// (flash_bwd_rowstats_kernel), which writes (-lse / scale, -D) per query
// row into [B, nh, Sq rounded up to 64] float pairs: each query tile is
// seen by up to Sk / 128 key blocks, and computing D in the block would
// read out again in every one of them; the pre-pass reads it once, and a
// tile's 64 pairs arrive as one aligned 512-byte cp.async.  Registers: dK
// and dV take 64 fp32 each a thread at hd 128, S^T and dP^T 32 each; one
// block per SM.  The pairs are the start values of the S^T and dP^T
// accumulators, so the products give S^T - lse / scale and dP^T - D
// directly and no register holds a column's lse or D (held, the 16
// columns' pairs took 32 registers and the kernel spilled at hd 128).
// At hd 256 dK and dV of all 256 columns would not fit, so two blocks
// share a key tile, each owning 128 columns of dK and dV and each
// recomputing S^T and dP^T (their products over the whole hd): 1.5x the
// operations of one block.
//
// Precision.  bf16 and fp16 take the tensor-core kernels or raise, and never
// drop to an FMA kernel.  The JAX _bwd_dkv_kernel keeps p_v and ds in
// fp32 for its second products (pallas_flash.py:455-472); in interpret
// mode on a CPU they are not rounded, while on the TPU's MXU at default
// precision they would be rounded to bf16.  This kernel rounds P_drop^T
// and dS^T to T in registers (the A operand), as FlashAttention-2/3
// do, and accumulates in fp32.  One fp16 rounding is 2^-11 relative
// against bf16's 2^-8; fp16's range (6.1e-5 .. 65504 normal) holds P in
// [0, 1] and dS at the scales of a loss-scaled gradient.
//
// flash_bwd_dq, float32, and flash_bwd_dkv, float32: fp32 FMAs on the
// CUDA cores, 256 threads per block, kept by design as the precision
// reference of the fp32 card-against-CPU checks:
// - flash_bwd_dq_kernel: one block per (batch * head, tile of BQ query
//   rows), looping over key tiles up to the causal diagonal;
// - flash_bwd_dkv_kernel: one block per (batch * KV head, tile of BK key
//   rows), looping over the query heads of its group (the sum over the
//   group in the block's fp32 registers) and, for each, over the query
//   tiles from the causal diagonal on.
// Their tiles are 64 x 64 for hd 64 and 128, and 32 x 32 for hd 256, so
// that four fp32 tiles of hd columns fit in the 227 KB of shared memory.
#include "attention_common.cuh"
#include "tc_common.cuh"

namespace ptt {

struct BwdArgs {
  const void *q, *k, *v, *o, *dO;
  const float* lse;
  const int* mask;        // [B, Sk] int32, or null
  void *dq, *dk, *dv;
  void* stats;            // bf16 / fp16 dk/dv: the row statistics
  int B, Sq, Sk, nh, nkv, causal;
  float scale;
  unsigned seed, thresh;  // dropout on when thresh > 0
  float keep_p;
  int heads, head0;       // the masks' head numbering (dropout_bh)
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
  const unsigned word =
      dropout_word(a.seed, dropout_bh(b, h, a.nh, a.heads, a.head0));
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
    const unsigned word =
        dropout_word(a.seed, dropout_bh(b, h, a.nh, a.heads, a.head0));
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

// ---------------------------------------------------------------------------
// flash_bwd_dq, bfloat16 and float16 on the tensor cores
// ---------------------------------------------------------------------------
constexpr int kDqRows = 128;     // query rows per block: two warpgroups
constexpr int kDqKeys = tc::kKeys;
constexpr int kDqThreads = 256;

// Blocks per SM the register budget is cut for: hd 64 fits two in 128
// registers without spilling, hd 128 needs 181 (one block, its two
// warpgroups sharing each K/V tile).  One-warpgroup blocks at two or three
// per SM, which let the warpgroups drift apart, ran slower on the H100 at
// hd 64 and 128: each K/V tile then feeds half as many rows.
constexpr int dq_tc_min_blocks(int D) { return D == 64 ? 2 : 1; }

// Shared memory of flash_bwd_dq_tc_kernel, bytes from the 1024-aligned
// base: Q and dO [D/64][128][64], NS stages of K and V [D/64][64][64] (all
// SW128), the stages' key-valid flags and D = rowsum(dO * out).  hd 256
// keeps one stage, to fit in 227 KB.
template <int D>
struct DqTcSmem {
  static constexpr int NS = D == 256 ? 1 : 2;
  static constexpr int rows = kDqRows;
  static constexpr int kv_stage = D * kDqKeys * 2;
  static constexpr int q = 0;
  static constexpr int dO = q + D * rows * 2;
  static constexpr int k = dO + D * rows * 2;
  static constexpr int v = k + NS * kv_stage;
  static constexpr int kok = v + NS * kv_stage;
  static constexpr int delta = kok + NS * kDqKeys * 4;
  static constexpr int bytes = delta + rows * 4 + tc::kGroupBytes;
};

template <class T, int D>
__global__ void __launch_bounds__(kDqThreads, dq_tc_min_blocks(D))
    flash_bwd_dq_tc_kernel(const BwdArgs a, float scale_log2) {
  using S = DqTcSmem<D>;
  constexpr int NS = S::NS, NB = D / 64;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  unsigned char* base = tc::align1024(tc_smem);
  const int Sq = a.Sq, Sk = a.Sk, nh = a.nh;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kDqRows;  // heaviest first
  const int b = bh / nh, h = bh % nh, hk = h / (nh / a.nkv);
  const int offset = Sk - Sq;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wrow = wg * 64 + ((tid >> 5) & 3) * 16 + g;
  const int row[2] = {q0 + wrow, q0 + wrow + 8};
  const int wg_first = q0 + wg * 64;
  const int wg_last = min(wg_first + 63, Sq - 1);
  const int wg_kend = a.causal ? min(Sk, wg_last + offset + 1) : Sk;
  const int q_last = min(q0 + kDqRows, Sq) - 1;
  const int k_end = a.causal ? min(Sk, q_last + offset + 1) : Sk;
  const int n_tiles = k_end > 0 ? (k_end + kDqKeys - 1) / kDqKeys : 0;
  const bool drop = a.thresh > 0;
  const unsigned word =
      dropout_word(a.seed, dropout_bh(b, h, a.nh, a.heads, a.head0));
  const float inv_keep = 1.f / a.keep_p;
  const T* q = static_cast<const T*>(a.q);
  const T* dO = static_cast<const T*>(a.dO);
  const T* o = static_cast<const T*>(a.o);
  auto load_kv = [&](int st, int k0) {
    tc::load_kv_tile<D, kDqThreads>(
        tc::smem_addr(base + S::k + st * S::kv_stage),
        tc::smem_addr(base + S::v + st * S::kv_stage),
        reinterpret_cast<int*>(base + S::kok) + st * kDqKeys,
        static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.mask, b,
        Sk, a.nkv, hk, k0);
  };
  auto qrow = [=](int r) -> long long {
    const int qp = q0 + r;
    return qp < Sq ? ((b * (long long)Sq + qp) * nh + h) * D : -1;
  };

  if (n_tiles > 0) {
    tc::load_tile<D, kDqThreads>(tc::smem_addr(base + S::q), q, kDqRows,
                                 qrow);
    tc::load_tile<D, kDqThreads>(tc::smem_addr(base + S::dO), dO, kDqRows,
                                 qrow);
    load_kv(0, 0);
    tc::cp_async_commit();
  }
  // D = rowsum(dO * out) in fp32: two neighbouring lanes per row
  {
    const int r = tid >> 1, half = tid & 1;
    const long long off = qrow(r);
    float sum = 0.f;
    if (off >= 0) {
#pragma unroll 4
      for (int c = half * (D / 2); c < (half + 1) * (D / 2); c += 8) {
        const uint4 x = *reinterpret_cast<const uint4*>(dO + off + c);
        const uint4 y = *reinterpret_cast<const uint4*>(o + off + c);
        const uint32_t* xp = reinterpret_cast<const uint32_t*>(&x);
        const uint32_t* yp = reinterpret_cast<const uint32_t*>(&y);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 xf = tc::unpack2<T>(xp[e]);
          const float2 yf = tc::unpack2<T>(yp[e]);
          sum = fmaf(xf.x, yf.x, sum);
          sum = fmaf(xf.y, yf.y, sum);
        }
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0) reinterpret_cast<float*>(base + S::delta)[r] = sum;
  }
  __syncthreads();
  float delta[2], lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    delta[r] = reinterpret_cast<const float*>(base + S::delta)[wrow + 8 * r];
    // rows past Sq: zero Q and dO, lse 0 -> p finite, ds 0, not written
    lse2[r] = row[r] < Sq
                  ? a.lse[(long long)bh * Sq + row[r]] * 1.4426950408889634f
                  : 0.f;
  }

  float dq[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[nb][i] = 0.f;
  const uint32_t qa = tc::smem_addr(base + S::q) + wg * 64 * tc::kRowBytes;
  const uint32_t da = tc::smem_addr(base + S::dO) + wg * 64 * tc::kRowBytes;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % NS, k0 = j * kDqKeys;
    if (NS == 1 && j > 0) {
      __syncthreads();  // every warpgroup is done with tile j - 1
      load_kv(0, k0);
      tc::cp_async_commit();
    }
    tc::cp_async_wait_all();
    __syncthreads();  // tile j landed; (NS 2) everyone is done with j - 1
    if (NS == 2 && j + 1 < n_tiles) {
      load_kv((j + 1) % NS, k0 + kDqKeys);
      tc::cp_async_commit();
    }
    if (wg_first > wg_last || k0 >= wg_kend) continue;
    const uint32_t ka = tc::smem_addr(base + S::k + st * S::kv_stage);
    const uint32_t va = tc::smem_addr(base + S::v + st * S::kv_stage);

    float s[32], dp[32];
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t cb = (kk >> 2), ko = (kk & 3) * 32;
      tc::wgmma_ss<T>(s, tc::desc(qa + cb * kDqRows * tc::kRowBytes + ko),
                      tc::desc(ka + cb * kDqKeys * tc::kRowBytes + ko),
                      kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t cb = (kk >> 2), ko = (kk & 3) * 32;
      tc::wgmma_ss<T>(dp, tc::desc(da + cb * kDqRows * tc::kRowBytes + ko),
                      tc::desc(va + cb * kDqKeys * tc::kRowBytes + ko),
                      kk > 0);
    }
    tc::wgmma_commit();
    tc::wgmma_wait_all();
    tc::fence_regs(s);
    tc::fence_regs(dp);

    const bool need_mask = a.mask != nullptr || k0 + kDqKeys > Sk ||
                           (a.causal && k0 + kDqKeys - 1 > wg_first + offset);
    const int* kok = reinterpret_cast<const int*>(base + S::kok) +
                     st * kDqKeys;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1, c = tc::acc_col(i, t);
      float p = tc::fast_exp2(fmaf(s[i], scale_log2, -lse2[r]));
      if (need_mask &&
          !(kok[c] && (!a.causal || k0 + c <= row[r] + offset)))
        p = 0.f;
      float gd = dp[i];
      if (drop)
        gd = dropout_keep(word, a.thresh, row[r], k0 + c) ? gd * inv_keep
                                                          : 0.f;
      s[i] = p * (gd - delta[r]) * a.scale;
    }
    uint32_t dsa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) tc::acc_to_a<T>(s, kk, dsa[kk]);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        tc::wgmma_rs_t<T>(dq[nb], dsa[kk],
                          tc::desc(ka + nb * kDqKeys * tc::kRowBytes +
                                   kk * 16 * tc::kRowBytes));
    tc::wgmma_commit();
    tc::wgmma_wait_all();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) tc::fence_regs(dq[nb]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) tc::fence_regs(dsa[kk]);
  }

  const float one[2] = {1.f, 1.f};
  tc::store_rows(static_cast<T*>(a.dq), dq, row, one, Sq, b, nh, h, t);
}

template <class T, int D>
cudaError_t launch_dq_tc(const BwdArgs& a, cudaStream_t stream) {
  const size_t smem = DqTcSmem<D>::bytes;
  auto kernel = flash_bwd_dq_tc_kernel<T, D>;
  static const cudaError_t attr = allow_smem(kernel, smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid(a.B * a.nh, (a.Sq + kDqRows - 1) / kDqRows);
  kernel<<<grid, kDqThreads, smem, stream>>>(a,
                                             a.scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// bf16 and fp16 dq take the tensor-core kernel or nothing (an hd it does
// not take raises; they never drop to the FMA kernel).
template <class T>
cudaError_t dispatch_dq_tc(int hd, const BwdArgs& a, cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch_dq_tc<T, 64>(a, stream);
    case 128:
      return launch_dq_tc<T, 128>(a, stream);
    case 256:
      return launch_dq_tc<T, 256>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// flash_bwd_dkv, bfloat16 and float16 on the tensor cores
// ---------------------------------------------------------------------------
constexpr int kDkvKeys = 128;    // keys per block: two warpgroups of 64
constexpr int kDkvRows = 64;     // query rows per step
constexpr int kDkvThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

// Columns of dK and dV one block owns: all of hd up to 128; at hd 256 two
// blocks each own 128.
__host__ __device__ constexpr int dkv_cols(int D) {
  return D < 128 ? D : 128;
}

// Row statistics of flash_bwd_dkv_tc_kernel, one pass before it:
// stats[b, h, i] = (-lse / scale, -D), D = rowsum(dO * out), for i < Sq,
// and (0, 0) up to Sq_pad (Sq rounded up to 64): the start values of the
// kernel's S^T and dP^T accumulators.  Eight lanes per row, each reading
// 16-byte chunks of dO and out.
template <class T, int D>
__global__ void __launch_bounds__(256)
    flash_bwd_rowstats_kernel(const BwdArgs a, float2* __restrict__ stats,
                              int Sq_pad) {
  const int bh = blockIdx.y, b = bh / a.nh, h = bh % a.nh;
  const int i = blockIdx.x * 32 + (threadIdx.x >> 3), sub = threadIdx.x & 7;
  float sum = 0.f;
  if (i < a.Sq) {
    const long long off = ((b * (long long)a.Sq + i) * a.nh + h) * D;
    const T* dO = static_cast<const T*>(a.dO) + off;
    const T* o = static_cast<const T*>(a.o) + off;
#pragma unroll
    for (int c = sub * 8; c < D; c += 64) {
      const uint4 x = *reinterpret_cast<const uint4*>(dO + c);
      const uint4 y = *reinterpret_cast<const uint4*>(o + c);
      const uint32_t* xp = reinterpret_cast<const uint32_t*>(&x);
      const uint32_t* yp = reinterpret_cast<const uint32_t*>(&y);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 xf = tc::unpack2<T>(xp[e]);
        const float2 yf = tc::unpack2<T>(yp[e]);
        sum = fmaf(xf.x, yf.x, sum);
        sum = fmaf(xf.y, yf.y, sum);
      }
    }
  }
#pragma unroll
  for (int w = 1; w < 8; w <<= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, w);
  if (sub == 0 && i < Sq_pad)
    stats[(long long)bh * Sq_pad + i] =
        i < a.Sq ? make_float2(-a.lse[(long long)bh * a.Sq + i] / a.scale,
                               -sum)
                 : make_float2(0.f, 0.f);
}

// Shared memory of flash_bwd_dkv_tc_kernel, bytes from the 1024-aligned
// base: K and V [D/64][128][64], NS stages of Q and dO [D/64][64][64] (all
// SW128), the stages' row statistics (64 float pairs each) and the
// key-valid flags.  hd 256 keeps one stage, to fit in 227 KB.
template <int D>
struct DkvTcSmem {
  static constexpr int NS = D == 256 ? 1 : 2;
  static constexpr int kv = D * kDkvKeys * 2;         // one K or V tile
  static constexpr int q_stage = D * kDkvRows * 2;    // one Q or dO tile
  static constexpr int stats_stage = kDkvRows * 8;
  static constexpr int k = 0;
  static constexpr int v = k + kv;
  static constexpr int q = v + kv;
  static constexpr int dO = q + NS * q_stage;
  static constexpr int stats = dO + NS * q_stage;
  static constexpr int kok = stats + NS * stats_stage;
  static constexpr int bytes = kok + kDkvKeys * 4 + tc::kGroupBytes;
};

template <class T, int D>
__global__ void __launch_bounds__(kDkvThreads, 1)
    flash_bwd_dkv_tc_kernel(const BwdArgs a, int Sq_pad, float scale_log2) {
  using S = DkvTcSmem<D>;
  constexpr int NS = S::NS;
  constexpr int NC = dkv_cols(D) / 64;      // owned 64-column blocks
  constexpr int NSPLIT = D / dkv_cols(D);   // blocks per key tile
  extern __shared__ __align__(16) unsigned char tc_smem[];
  unsigned char* base = tc::align1024(tc_smem);
  const int Sq = a.Sq, Sk = a.Sk, nh = a.nh, nkv = a.nkv;
  const int group = nh / nkv;
  const int bhk = blockIdx.x / NSPLIT;
  const int c0 = blockIdx.x % NSPLIT * NC;  // first owned column block
  const int b = bhk / nkv, hk = bhk % nkv;
  const int k0 = blockIdx.y * kDkvKeys;     // ascending: tile 0 heaviest
  const int offset = Sk - Sq;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wrow = wg * 64 + ((tid >> 5) & 3) * 16 + g;  // key in block
  const int key[2] = {k0 + wrow, k0 + wrow + 8};
  const int kw0 = k0 + wg * 64;             // this warpgroup's first key
  const int n_qt = (Sq + kDkvRows - 1) / kDkvRows;
  // the first query row that sees key k0 is k0 - (Sk - Sq)
  const int qt_begin =
      a.causal ? min(n_qt, max(0, k0 - offset) / kDkvRows) : 0;
  const int per_head = n_qt - qt_begin;
  const int n_it = group * per_head;        // (head, query tile) steps
  const bool drop = a.thresh > 0;
  const float inv_keep = 1.f / a.keep_p;
  const T* q = static_cast<const T*>(a.q);
  const T* dO = static_cast<const T*>(a.dO);
  const float2* stats = static_cast<const float2*>(a.stats);
  int* kok = reinterpret_cast<int*>(base + S::kok);

  // step it: query head hk * group + it / per_head, query tile
  // qt_begin + it % per_head
  auto load_q = [&](int st, int it) {
    const int h = hk * group + it / per_head;
    const int q0 = (qt_begin + it % per_head) * kDkvRows;
    auto qrow = [=](int r) -> long long {
      const int qp = q0 + r;
      return qp < Sq ? ((b * (long long)Sq + qp) * nh + h) * D : -1;
    };
    tc::load_tile<D, kDkvThreads>(
        tc::smem_addr(base + S::q + st * S::q_stage), q, kDkvRows, qrow);
    tc::load_tile<D, kDkvThreads>(
        tc::smem_addr(base + S::dO + st * S::q_stage), dO, kDkvRows, qrow);
    if (tid < S::stats_stage / 16)
      tc::cp_async16(tc::smem_addr(base + S::stats + st * S::stats_stage) +
                         tid * 16,
                     stats + (long long)(b * nh + h) * Sq_pad + q0 + tid * 2,
                     16);
  };

  if (n_it > 0) {
    auto krow = [=](int r) -> long long {
      const int kp = k0 + r;
      if (kp >= Sk) return -1;
      const long long row = b * (long long)Sk + kp;
      if (a.mask != nullptr && a.mask[row] == 0) return -1;
      return (row * nkv + hk) * D;
    };
    tc::load_tile<D, kDkvThreads>(tc::smem_addr(base + S::k),
                                  static_cast<const T*>(a.k), kDkvKeys,
                                  krow);
    tc::load_tile<D, kDkvThreads>(tc::smem_addr(base + S::v),
                                  static_cast<const T*>(a.v), kDkvKeys,
                                  krow);
    if (tid < kDkvKeys) kok[tid] = krow(tid) >= 0;
    load_q(0, 0);
    tc::cp_async_commit();
  }

  float dk[NC][32], dv[NC][32];
#pragma unroll
  for (int nb = 0; nb < NC; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[nb][i] = dv[nb][i] = 0.f;
  const uint32_t ka = tc::smem_addr(base + S::k) + wg * 64 * tc::kRowBytes;
  const uint32_t va = tc::smem_addr(base + S::v) + wg * 64 * tc::kRowBytes;
  const float kp = drop ? a.keep_p : 1.f;

  for (int it = 0; it < n_it; ++it) {
    const int st = NS == 1 ? 0 : (it & 1);
    if (NS == 1 && it > 0) {
      __syncthreads();  // every warpgroup is done with step it - 1
      load_q(0, it);
      tc::cp_async_commit();
    }
    tc::cp_async_wait_all();
    __syncthreads();  // step it landed; (NS 2) everyone is done with it - 1
    if (NS == 2 && it + 1 < n_it) {
      load_q((it + 1) & 1, it + 1);
      tc::cp_async_commit();
    }
    const int h = hk * group + it / per_head;
    const int q0 = (qt_begin + it % per_head) * kDkvRows;
    const int q_last = min(q0 + kDkvRows, Sq) - 1;
    // a warpgroup none of whose keys a row of this tile sees skips it
    if (kw0 >= Sk || (a.causal && q_last + offset < kw0)) continue;
    const uint32_t qa = tc::smem_addr(base + S::q + st * S::q_stage);
    const uint32_t da = tc::smem_addr(base + S::dO + st * S::q_stage);
    const float2* rs = reinterpret_cast<const float2*>(
        base + S::stats + st * S::stats_stage);

    // S^T = K Q^T and dP^T = V dO^T: rows keys, columns queries, started
    // from each column's (-lse / scale, -D keep_p): s holds S - lse /
    // scale and dp, dP - D keep_p, with no register spent on lse or D
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float2 row = rs[tc::acc_col(i, t)];
      s[i] = row.x;
      dp[i] = row.y * kp;
    }
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t cb = (kk >> 2), ko = (kk & 3) * 32;
      tc::wgmma_ss<T>(s, tc::desc(ka + cb * kDkvKeys * tc::kRowBytes + ko),
                      tc::desc(qa + cb * kDkvRows * tc::kRowBytes + ko), 1);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t cb = (kk >> 2), ko = (kk & 3) * 32;
      tc::wgmma_ss<T>(dp, tc::desc(va + cb * kDkvKeys * tc::kRowBytes + ko),
                      tc::desc(da + cb * kDkvRows * tc::kRowBytes + ko), 1);
    }
    tc::wgmma_commit();
    tc::wgmma_wait_all();
    tc::fence_regs(s);
    tc::fence_regs(dp);

    const bool need_mask = a.mask != nullptr || kw0 + 64 > Sk ||
                           q0 + kDkvRows > Sq ||
                           (a.causal && kw0 + 63 > q0 + offset);
    const unsigned word =
        dropout_word(a.seed, dropout_bh(b, h, nh, a.heads, a.head0));
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1, c = tc::acc_col(i, t), qp = q0 + c;
      float p = tc::fast_exp2(s[i] * scale_log2);
      if (need_mask && !(kok[wrow + 8 * r] && qp < Sq &&
                         (!a.causal || key[r] <= qp + offset)))
        p = 0.f;
      float gd = dp[i], pd = p;                // gd = dP - D
      if (drop) {
        // kept: (dP - D keep_p) / keep_p = dP / keep_p - D; dropped: -D
        const bool keep = dropout_keep(word, a.thresh, qp, key[r]);
        gd = keep ? gd * inv_keep : rs[c].y;
        pd = keep ? p * inv_keep : 0.f;
      }
      s[i] = pd;                               // P_drop^T
      dp[i] = p * gd * a.scale;                // dS^T
    }
    uint32_t pa[4][4], sa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      tc::acc_to_a<T>(s, kk, pa[kk]);
      tc::acc_to_a<T>(dp, kk, sa[kk]);
    }
    // dV += P_drop^T dO, dK += dS^T Q: the [query][d] tiles read
    // transposed, this block's column blocks c0 .. c0 + NC - 1
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nb = 0; nb < NC; ++nb)
        tc::wgmma_rs_t<T>(dv[nb], pa[kk],
                          tc::desc(da + (c0 + nb) * kDkvRows * tc::kRowBytes +
                                   kk * 16 * tc::kRowBytes));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nb = 0; nb < NC; ++nb)
        tc::wgmma_rs_t<T>(dk[nb], sa[kk],
                          tc::desc(qa + (c0 + nb) * kDkvRows * tc::kRowBytes +
                                   kk * 16 * tc::kRowBytes));
    tc::wgmma_commit();
    tc::wgmma_wait_all();
#pragma unroll
    for (int nb = 0; nb < NC; ++nb) {
      tc::fence_regs(dv[nb]);
      tc::fence_regs(dk[nb]);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      tc::fence_regs(pa[kk]);
      tc::fence_regs(sa[kk]);
    }
  }

  // keys past Sk are not written; every other key is, zeros included
  const float one[2] = {1.f, 1.f};
  tc::store_rows<NC, D>(static_cast<T*>(a.dk), dk, key, one, Sk, b, nkv, hk,
                        t, c0 * 64);
  tc::store_rows<NC, D>(static_cast<T*>(a.dv), dv, key, one, Sk, b, nkv, hk,
                        t, c0 * 64);
}

template <class T, int D>
cudaError_t launch_dkv_tc(const BwdArgs& a, cudaStream_t stream) {
  const int Sq_pad = (a.Sq + kDkvRows - 1) / kDkvRows * kDkvRows;
  flash_bwd_rowstats_kernel<T, D><<<dim3(Sq_pad / 32, a.B * a.nh), 256, 0,
                                 stream>>>(a, static_cast<float2*>(a.stats),
                                           Sq_pad);
  const cudaError_t pre = cudaGetLastError();
  if (pre != cudaSuccess) return pre;
  const size_t smem = DkvTcSmem<D>::bytes;
  auto kernel = flash_bwd_dkv_tc_kernel<T, D>;
  static const cudaError_t attr = allow_smem(kernel, smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid(a.B * a.nkv * (D / dkv_cols(D)),
            (a.Sk + kDkvKeys - 1) / kDkvKeys);
  kernel<<<grid, kDkvThreads, smem, stream>>>(a, Sq_pad, a.scale * kLog2e);
  return cudaGetLastError();
}

// bf16 and fp16 dk/dv take the tensor-core kernel or nothing, like dq.
template <class T>
cudaError_t dispatch_dkv_tc(int hd, const BwdArgs& a, cudaStream_t stream) {
  if (a.stats == nullptr) return cudaErrorInvalidValue;
  switch (hd) {
    case 64:
      return launch_dkv_tc<T, 64>(a, stream);
    case 128:
      return launch_dkv_tc<T, 128>(a, stream);
    case 256:
      return launch_dkv_tc<T, 256>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// FMA kernels: flash_bwd_dq (fp32), flash_bwd_dkv (fp32)
// ---------------------------------------------------------------------------
template <typename T, int D, int BQ, int BK, bool DKV>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  const size_t smem = sizeof(BwdSmem<D, BQ, BK>);
  if constexpr (!DKV) {
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

template <typename T, bool DKV>
cudaError_t dispatch_bwd(int hd, const BwdArgs& a, cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch_bwd<T, 64, 64, 64, DKV>(a, stream);
    case 128:
      return launch_bwd<T, 128, 64, 64, DKV>(a, stream);
    case 256:
      return launch_bwd<T, 256, 32, 32, DKV>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

int run_bwd(BwdArgs a, int hd, int dtype, bool dkv, void* stream) {
  if (a.B <= 0 || a.Sq <= 0 || a.Sk <= 0 || a.nkv <= 0 || a.nh % a.nkv)
    return (int)cudaErrorInvalidValue;
  a.scale = 1.0f / sqrtf((float)hd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 1)
    err = dkv ? dispatch_dkv_tc<__nv_bfloat16>(hd, a, s)
              : dispatch_dq_tc<__nv_bfloat16>(hd, a, s);
  else if (dtype == 2)
    err = dkv ? dispatch_dkv_tc<__half>(hd, a, s)
              : dispatch_dq_tc<__half>(hd, a, s);
  else if (dtype == 0)
    err = dkv ? dispatch_bwd<float, true>(hd, a, s)
              : dispatch_bwd<float, false>(hd, a, s);
  return (int)err;
}

}  // namespace ptt

// q, out, dO, dq [B, Sq, nh, hd]; k, v, dk, dv [B, Sk, nkv, hd]; lse
// [B, nh, Sq] fp32; mask [B, Sk] int32 or null; all contiguous on the
// device.  dtype: 0 = float32 (FMA kernels), 1 = bfloat16, 2 = float16
// (tensor-core kernels); any other code is refused.  stats (bf16 and
// fp16 dk/dv only, else null): scratch of
// [B, nh, Sq rounded up to 64, 2] fp32 for the row statistics.
// seed, thresh and keep_p are the forward's (dropout on when thresh > 0).
// Each returns the cudaError_t of its launch (0 = success).
extern "C" int ptt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* out, const void* dO,
                                const void* lse, void* dq, const void* mask,
                                int B, int Sq, int Sk, int nh, int nkv,
                                int hd, int causal, int dtype, unsigned seed,
                                unsigned thresh, float keep_p, int heads,
                                int head0, void* stream) {
  ptt::BwdArgs a{q, k, v, out, dO, static_cast<const float*>(lse),
                 static_cast<const int*>(mask), dq, nullptr, nullptr,
                 nullptr, B, Sq, Sk, nh, nkv, causal, 0.f, seed, thresh,
                 keep_p, heads, head0};
  return ptt::run_bwd(a, hd, dtype, false, stream);
}

extern "C" int ptt_flash_bwd_dkv(const void* q, const void* k,
                                 const void* v, const void* out,
                                 const void* dO, const void* lse, void* dk,
                                 void* dv, void* stats, const void* mask,
                                 int B, int Sq,
                                 int Sk, int nh, int nkv, int hd, int causal,
                                 int dtype, unsigned seed, unsigned thresh,
                                 float keep_p, int heads, int head0,
                                 void* stream) {
  ptt::BwdArgs a{q, k, v, out, dO, static_cast<const float*>(lse),
                 static_cast<const int*>(mask), nullptr, dk, dv, stats,
                 B, Sq, Sk, nh, nkv, causal, 0.f, seed, thresh, keep_p,
                 heads, head0};
  return ptt::run_bwd(a, hd, dtype, true, stream);
}
