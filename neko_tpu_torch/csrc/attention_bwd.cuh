// The causal attention backward tiles that whole_head_attention_bwd.cu (#2,
// #4), blocked_attention_bwd.cu (#7, #8, #9) and ring_attention.cu (#12, #13)
// launch.  They replace the TPU kernels neko_tpu/ops/attention_kernel.py:220
// (_bwd_kernel) and :256 (_bwd_kernel_bsd), neko_tpu/ops/blocked_attention.py
// :241 (_dq_kernel), :290 (_bwd_fused_kernel) and :390 (_dkv_kernel), and
// neko_tpu/ops/ring_kernel.py:158 (_ring_dq_kernel) and :208
// (_ring_dkv_kernel).  With ks the keep/scale the forward applied
// (attention_common.cuh) and delta = rowsum(do * o) computed before the launch:
//
//   p  = exp(s * sm_scale - m) / l     (0 where masked, and on rows with l = 0)
//   dv = (p * ks)^T do
//   dp = (do v^T) * ks
//   ds = p * (dp - delta) * sm_scale
//   dq = ds k,  dk = ds^T q
//
// Row stats, a compile-time choice (kLse): the whole-head forward's lse
// (read as m = lse, 1 / l = 1) or the blocked forward's (m, l).
//
// What bounds it on the H100: the five products of the fused backward are
// 10 * hd FLOPs per visible (row, key) pair.  At the flagship train shape
// (B = 16, H = 24, S = 1024, hd = 32, causal) that is 0.0652 ms at the 989
// TFLOP/s bf16 tensor-core rate, at `long` (B = 8, S = 2048) 0.1303 ms;
// the operands are ~100-180 MB (0.03-0.05 ms at 3.35 TB/s): operations.  At
// hd = 32 each product is only 32 deep or 32 wide, so per (row, key) pair
// the elementwise work (exp, the masks, the keep byte, ds) costs as much as
// the products on the tensor cores; the design keeps that work in registers
// and off shared memory.
//
// bf16 inputs run the tensor-core tiles (namespace tc, on the primitives of
// attention_tc.cuh), for hd in {16, 32, 64, 128}, compiled per hd:
//
// * every product is mma.sync.m16n8k16 with bf16 operands and fp32
//   accumulators, its operands read from shared memory by ldmatrix
//   (.trans for the transposed ones).  p * ks and ds are rounded to bf16
//   before the products that take them, as neko_tpu rounds them to the
//   input dtype (blocked_attention.py:281, 367, 371, 436, 440): the same
//   arithmetic as the plain versions, whose sums are fp32 too;
// * tiles stay bf16 in shared memory, rows padded by 16 bytes so that the
//   eight rows an ldmatrix reads fall in distinct banks.  They arrive by
//   16-byte cp.async copies through a two-stage ring: the next tile's copies
//   are in flight while this tile's products run.  The row stats come with
//   them (4-byte cp.async);
// * kv: one block of four warps per 64-key tile keeps dk and dv in
//   registers (a warp per 16 keys) and walks the q tiles from the diagonal
//   down.  It computes s^T = k q^T and dp^T = v do^T, so p and ds come out
//   as accumulator fragments whose layout is, register for register, the A
//   operand of dv += (p ks)^T do and dk += ds^T q: p and ds never leave the
//   registers.  With kFusedDq (#8) ds^T also goes to shared memory in bf16,
//   the one layout change, and the block adds its dq partial ds k (another
//   tensor-core product) into the fp32 scratch by float2 atomics: 64 x hd / 2
//   vector atomics per 64 x 64 tile pair.  The atomics make dq's summation
//   order change from run to run;
// * dq: one block of four warps per 64-row q tile (a warp per 16 rows) walks
//   the 64-key tiles at or below the diagonal, each in two passes of 32 keys
//   (so that s and dp leave room for dq's accumulators); ds comes out of
//   s = q k^T and dp = do v^T as fragments that are the A operand of
//   dq += ds k.  No atomics: deterministic;
// * the keep bytes: a warp draws the Philox blocks its fragments cover, once
//   per tile pair, into a per-warp word buffer that its lanes read in the
//   fragment's (row, key) layout;
// * at hd = 128 the kv block takes 32 q rows a step, so that dk, dv (128
//   fp32 registers a thread) and s, dp fit without spilling.
//
// fp32 inputs run the CUDA-core tiles (namespace f32; hd in {32, 64, 128},
// the wrappers pad hd 16 to 32): no tensor-core fp32 product exists without
// TF32's loss of precision, and no train path runs fp32 on the card.  One
// block per (32-key tile, head, batch) keeps dk, dv in registers and loops
// over the 64-row q tiles, a lane per key; the dq block owns 64 rows.
//
// Hopper blocks run in parallel in no order, and no block holds a full-S
// fp32 dk/dv beside its tiles, so the TPU's scheme -- dk/dv resident across a
// sequential grid -- does not carry over.  Causal imbalance: key tile 0 sees
// every q tile and the last q tile sees every key tile, so the tile index is
// the slowest grid dimension, ordered so that the heaviest blocks start
// first (key tiles ascending, q tiles descending).
//
// Ring mode (kRing, with the lse row stats): q, do and the row stats are the
// S rows of one sequence shard at global row offset q_off; k, v are the S
// keys of the visiting shard at global column offset k_off.  The causal test,
// the key window and the keep mask take global rows and columns, and key tiles
// start at global multiples of the tile (a multiple of the keep mask's
// 16-byte draws), so the offsets may be any integers.  The outputs are fp32
// partials: dq of the local rows from this kv block alone (#12), dk and dv of
// the VISITING block from the local rows alone (#13); the caller adds them up
// over the ring.
//
// Fills are finite (-1e30, never -inf), and masked probabilities are exactly
// 0, so rows that see no key get zero gradients, never NaN.
//
// Offsets: batch and head offsets and the rows of the row stats, delta and
// the dq scratch are 64-bit.

#pragma once

#include <initializer_list>
#include <type_traits>

#include "attention_common.cuh"
#include "attention_tc.cuh"

namespace {

using namespace whk;

namespace bwd {

// (m, 1 / l) of row `idx` of [B, H, S]: from lse (1 / l = 1) or from (m, l)
// (1 / l = 0 where l = 0, a row that sees no key)
template <bool kLse>
__device__ __forceinline__ void row_stats(const AttnArgs& a, long long idx, float& m,
                                          float& inv_l) {
  if constexpr (kLse) {
    m = a.lse[idx];
    inv_l = 1.f;
  } else {
    m = a.m[idx];
    const float l = a.l[idx];
    inv_l = l > 0.f ? 1.f / l : 0.f;
  }
}

// --------------------------------------------------- fp32: CUDA-core tiles
namespace f32 {

constexpr int kBlockM = 64;  // query rows per tile
constexpr int kBlockN = 32;  // keys per tile (one key per lane)
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = kBlockM / kWarps;
constexpr int kPP = kBlockN + 1;  // padded row stride of the p / ds tiles

template <int D>
constexpr int kv_smem_floats() {
  // k, v tiles [kBlockN][D + 1]; q, do tiles [kBlockM][D]; p*ks and ds
  // tiles [kBlockM][kBlockN + 1]; m, 1/l, delta [kBlockM]
  return 2 * kBlockN * (D + 1) + 2 * kBlockM * D + 2 * kBlockM * kPP + 3 * kBlockM;
}

// dk, dv of one key tile; with kFusedDq also its share of dq.
template <typename T, int D, bool kLse, bool kFusedDq, bool kRing>
__global__ void __launch_bounds__(kWarps * 32)
attention_bwd_kv_kernel_fp32(const AttnArgs a) {
  static_assert(!(kRing && kFusedDq), "the ring has no fused dq phase");
  using TO = std::conditional_t<kRing, float, T>;  // the ring partials are fp32
  constexpr int kDL = D / 32;
  constexpr int kKP = D + 1;
  constexpr int kKeysPerWarp = kBlockN / kWarps;  // 4: keys warp + 8j
  extern __shared__ float smem[];
  float* sk = smem;
  float* sv = sk + kBlockN * kKP;
  float* sq = sv + kBlockN * kKP;
  float* sdo = sq + kBlockM * D;
  float* sp = sdo + kBlockM * D;
  float* sds = sp + kBlockM * kPP;
  float* sm = sds + kBlockM * kPP;
  float* sinvl = sm + kBlockM;
  float* sdelta = sinvl + kBlockM;
  __shared__ uint32_t keep_words[kWarps][kRowsPerWarp][kBlockN / 4];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  // global offsets of local row 0 and local key 0 (0 outside the ring)
  const int q_off = kRing ? a.q_off : 0;
  const int k_off = kRing ? a.k_off : 0;
  // this block's key tile as global columns [c0, c0 + 32); key tile 0, which
  // every q tile sees, first
  const int c0 = (k_off / kBlockN + blockIdx.z) * kBlockN;
  const int S = a.S;
  const T* q = head_ptr<T>(a.q, b, h);
  const T* k = head_ptr<T>(a.k, b, h);
  const T* v = head_ptr<T>(a.v, b, h);
  const T* dout = head_ptr<T>(a.dout, b, h);
  const long long bh_row = static_cast<long long>(b * a.H + h) * S;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row0 = warp * kRowsPerWarp;
  const int st = max(a.start[b], 0);
  const int en = kRing ? a.end[b] : min(a.end[b], S);
  const bool drop = a.drop_threshold > 0;
  const uint32_t seed = drop ? static_cast<uint32_t>(a.seed[0]) : 0u;
  const uint32_t bh = static_cast<uint32_t>(b * a.H + h);

  for (int i = tid; i < kBlockN * D; i += blockDim.x) {
    const int c = c0 - k_off + i / D, d = i % D;  // local key
    float kx = 0.f, vx = 0.f;
    // one branch for both loads, so their latencies overlap
    if ((!kRing || c >= 0) && c < S) {
      kx = load(&k[c * a.k.ss + d]);
      vx = load(&v[c * a.v.ss + d]);
    }
    sk[(i / D) * kKP + d] = kx;
    sv[(i / D) * kKP + d] = vx;
  }

  float dk_acc[kKeysPerWarp][kDL], dv_acc[kKeysPerWarp][kDL];
#pragma unroll
  for (int j = 0; j < kKeysPerWarp; ++j) {
#pragma unroll
    for (int t = 0; t < kDL; ++t) dk_acc[j][t] = dv_acc[j][t] = 0.f;
  }

  // rows that see a key of this tile: r >= max(c0, st), and only if the tile
  // meets [st, en)
  const bool any_key = c0 < en && c0 + kBlockN > st;
  const int r_first = max(max(c0, st) - q_off, 0);  // local row
  const int r_beg = any_key ? (r_first / kBlockM) * kBlockM : S;
  const int c = c0 + lane;  // this lane's key in phase A (global column)

  for (int r0 = r_beg; r0 < S; r0 += kBlockM) {
    __syncthreads();  // previous tile consumed (and k, v tiles written)
    for (int i = tid; i < kBlockM * D; i += blockDim.x) {
      const int r = r0 + i / D, d = i % D;
      float qx = 0.f, dox = 0.f;
      if (r < S) {  // one branch for both loads, so their latencies overlap
        qx = load(&q[r * a.q.ss + d]);
        dox = load(&dout[r * a.dout.ss + d]);
      }
      sq[i] = qx;
      sdo[i] = dox;
    }
    if (tid < kBlockM) {
      const int r = r0 + tid;
      float mr = 0.f, inv_l = 0.f, dr = 0.f;
      if (r < S) {
        row_stats<kLse>(a, bh_row + r, mr, inv_l);
        dr = a.delta[bh_row + r];
      }
      sm[tid] = mr;
      sinvl[tid] = inv_l;
      sdelta[tid] = dr;
    }
    if (drop) draw_keep_words(keep_words[warp], seed, bh, q_off + r0 + row0, c0, lane);
    __syncthreads();

    // phase A: this warp's 8 rows x this lane's key
    float s[kRowsPerWarp], dp[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = dp[i] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kd = sk[lane * kKP + d];
      const float vd = sv[lane * kKP + d];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        s[i] = fmaf(sq[(row0 + i) * D + d], kd, s[i]);
        dp[i] = fmaf(sdo[(row0 + i) * D + d], vd, dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int ri = row0 + i;
      const int r = r0 + ri;
      bool ok = c <= q_off + r && c >= st && c < en && r < S;
      if constexpr (kRing) ok = ok && c >= k_off && c < k_off + S;
      const float p = ok ? expf(s[i] * a.sm_scale - sm[ri]) * sinvl[ri] : 0.f;
      float ks = 1.f;
      if (drop) ks = keep_byte(keep_words[warp], i, lane) >= a.drop_threshold ? a.drop_scale : 0.f;
      sp[ri * kPP + lane] = p * ks;
      sds[ri * kPP + lane] = p * (dp[i] * ks - sdelta[ri]) * a.sm_scale;
    }
    __syncthreads();

    // phase B: dv[j] += sum_r p[r, j] do[r], dk[j] += sum_r ds[r, j] q[r]
    // for this warp's keys j = warp + 8m and dims d = lane + 32t
#pragma unroll 4
    for (int r = 0; r < kBlockM; ++r) {
      float dov[kDL], qv[kDL];
#pragma unroll
      for (int t = 0; t < kDL; ++t) {
        dov[t] = sdo[r * D + lane + 32 * t];
        qv[t] = sq[r * D + lane + 32 * t];
      }
#pragma unroll
      for (int j = 0; j < kKeysPerWarp; ++j) {
        const float pr = sp[r * kPP + warp + kWarps * j];
        const float dsr = sds[r * kPP + warp + kWarps * j];
#pragma unroll
        for (int t = 0; t < kDL; ++t) {
          dv_acc[j][t] = fmaf(pr, dov[t], dv_acc[j][t]);
          dk_acc[j][t] = fmaf(dsr, qv[t], dk_acc[j][t]);
        }
      }
    }

    if constexpr (kFusedDq) {
      // phase C: dq[r] += sum_j ds[r, j] k[j] for this warp's 8 rows and
      // dims d = lane + 32t, added into the scratch (the blocks of the other
      // key tiles add into the same rows).  Rows that see no key of this
      // tile have ds = 0 and are skipped.
      float dq_part[kRowsPerWarp][kDL];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
#pragma unroll
        for (int t = 0; t < kDL; ++t) dq_part[i][t] = 0.f;
      }
#pragma unroll 4
      for (int j = 0; j < kBlockN; ++j) {
        float kj[kDL];
#pragma unroll
        for (int t = 0; t < kDL; ++t) kj[t] = sk[j * kKP + lane + 32 * t];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const float dsj = sds[(row0 + i) * kPP + j];
#pragma unroll
          for (int t = 0; t < kDL; ++t) dq_part[i][t] = fmaf(dsj, kj[t], dq_part[i][t]);
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int r = r0 + row0 + i;
        if (r < r_first || r >= S) continue;
        float* dst = a.dq_acc + (bh_row + r) * D;
#pragma unroll
        for (int t = 0; t < kDL; ++t) atomicAdd(dst + lane + 32 * t, dq_part[i][t]);
      }
    }
  }

  TO* dk = head_ptr<TO>(a.dk, b, h);
  TO* dv = head_ptr<TO>(a.dv, b, h);
#pragma unroll
  for (int j = 0; j < kKeysPerWarp; ++j) {
    const int cj = c0 - k_off + warp + kWarps * j;  // local key
    if ((kRing && cj < 0) || cj >= S) continue;
#pragma unroll
    for (int t = 0; t < kDL; ++t) {
      store(&dk[cj * a.dk.ss + lane + 32 * t], dk_acc[j][t]);
      store(&dv[cj * a.dv.ss + lane + 32 * t], dv_acc[j][t]);
    }
  }
}

template <int D>
constexpr int dq_smem_floats() {
  // q, do tiles [kBlockM][D]; k, v tiles [kBlockN][D + 1]
  return 2 * kBlockM * D + 2 * kBlockN * (D + 1);
}

// dq of one q tile, over the key tiles at or below the diagonal.
template <typename T, int D, bool kLse, bool kRing>
__global__ void __launch_bounds__(kWarps * 32)
attention_bwd_dq_kernel_fp32(const AttnArgs a) {
  using TO = std::conditional_t<kRing, float, T>;  // the ring partial is fp32
  constexpr int kDL = D / 32;
  constexpr int kKP = D + 1;
  extern __shared__ float smem[];
  float* sq = smem;
  float* sdo = sq + kBlockM * D;
  float* sk = sdo + kBlockM * D;
  float* sv = sk + kBlockN * kKP;
  __shared__ uint32_t keep_words[kWarps][kRowsPerWarp][kBlockN / 4];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int r0 = (gridDim.z - 1 - blockIdx.z) * kBlockM;  // heaviest q tile first
  const int S = a.S;
  const T* q = head_ptr<T>(a.q, b, h);
  const T* k = head_ptr<T>(a.k, b, h);
  const T* v = head_ptr<T>(a.v, b, h);
  const T* dout = head_ptr<T>(a.dout, b, h);
  const long long bh_row = static_cast<long long>(b * a.H + h) * S;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row0 = warp * kRowsPerWarp;
  // global offsets of local row 0 and local key 0 (0 outside the ring)
  const int q_off = kRing ? a.q_off : 0;
  const int k_off = kRing ? a.k_off : 0;
  const int st = max(a.start[b], 0);
  const int en = kRing ? a.end[b] : min(a.end[b], S);
  // the key tiles this q tile sees, as global columns
  const int c_end = min(min(en, k_off + S), q_off + min(r0 + kBlockM, S));
  const int c_beg = (max(st, k_off) / kBlockN) * kBlockN;
  const bool drop = a.drop_threshold > 0;
  const uint32_t seed = drop ? static_cast<uint32_t>(a.seed[0]) : 0u;
  const uint32_t bh = static_cast<uint32_t>(b * a.H + h);

  for (int i = tid; i < kBlockM * D; i += blockDim.x) {
    const int r = r0 + i / D, d = i % D;
    float qx = 0.f, dox = 0.f;
    if (r < S) {  // one branch for both loads, so their latencies overlap
      qx = load(&q[r * a.q.ss + d]);
      dox = load(&dout[r * a.dout.ss + d]);
    }
    sq[i] = qx;
    sdo[i] = dox;
  }
  float mrow[kRowsPerWarp], inv_l[kRowsPerWarp], delta[kRowsPerWarp], acc[kRowsPerWarp][kDL];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = r0 + row0 + i;
    mrow[i] = inv_l[i] = delta[i] = 0.f;
    if (r < S) {
      row_stats<kLse>(a, bh_row + r, mrow[i], inv_l[i]);
      delta[i] = a.delta[bh_row + r];
    }
#pragma unroll
    for (int t = 0; t < kDL; ++t) acc[i][t] = 0.f;
  }

  for (int c0 = c_beg; c0 < c_end; c0 += kBlockN) {
    __syncthreads();  // previous tile consumed (and q, do tiles written)
    for (int i = tid; i < kBlockN * D; i += blockDim.x) {
      const int c = c0 - k_off + i / D, d = i % D;  // local key
      float kx = 0.f, vx = 0.f;
      // one branch for both loads, so their latencies overlap
      if ((!kRing || c >= 0) && c < S) {
        kx = load(&k[c * a.k.ss + d]);
        vx = load(&v[c * a.v.ss + d]);
      }
      sk[(i / D) * kKP + d] = kx;
      sv[(i / D) * kKP + d] = vx;
    }
    if (drop) draw_keep_words(keep_words[warp], seed, bh, q_off + r0 + row0, c0, lane);
    __syncthreads();

    const int c = c0 + lane;  // global column
    float s[kRowsPerWarp], dp[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = dp[i] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kd = sk[lane * kKP + d];
      const float vd = sv[lane * kKP + d];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        s[i] = fmaf(sq[(row0 + i) * D + d], kd, s[i]);
        dp[i] = fmaf(sdo[(row0 + i) * D + d], vd, dp[i]);
      }
    }
    float ds[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = r0 + row0 + i;
      bool ok = c <= q_off + r && c >= st && c < en && r < S;
      if constexpr (kRing) ok = ok && c >= k_off && c < k_off + S;
      const float p = ok ? expf(s[i] * a.sm_scale - mrow[i]) * inv_l[i] : 0.f;
      float ks = 1.f;
      if (drop) ks = keep_byte(keep_words[warp], i, lane) >= a.drop_threshold ? a.drop_scale : 0.f;
      ds[i] = p * (dp[i] * ks - delta[i]) * a.sm_scale;
    }
#pragma unroll 4
    for (int j = 0; j < kBlockN; ++j) {
      float kj[kDL];
#pragma unroll
      for (int t = 0; t < kDL; ++t) kj[t] = sk[j * kKP + lane + 32 * t];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float dsj = __shfl_sync(0xffffffffu, ds[i], j);
#pragma unroll
        for (int t = 0; t < kDL; ++t) acc[i][t] = fmaf(dsj, kj[t], acc[i][t]);
      }
    }
  }

  TO* dq = head_ptr<TO>(a.dq, b, h);
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = r0 + row0 + i;
    if (r >= S) continue;
#pragma unroll
    for (int t = 0; t < kDL; ++t) store(&dq[r * a.dq.ss + lane + 32 * t], acc[i][t]);
  }
}

}  // namespace f32

// ------------------------------------------------ bf16: tensor-core tiles
namespace tc {

using namespace ::tc;

// q rows a kv block takes a step: 64, or 32 at hd = 128, where dk and dv
// alone hold 128 fp32 registers a thread
template <int D>
__host__ __device__ constexpr int kv_rows() {
  return D >= 128 ? 32 : 64;
}

template <int D, bool kFusedDq>
__host__ __device__ constexpr int kv_smem_bytes() {
  constexpr int M = kv_rows<D>(), P = D + kPad;
  // k, v [kKeys][P]; q, do [2 stages][M][P]; ds^T [kKeys][M + kPad] (fused);
  // m, l, delta [2 stages][3][M]; keep words [kWarps][M][4]
  return (2 * kKeys * P + 4 * M * P + (kFusedDq ? kKeys * (M + kPad) : 0)) * 2 +
         2 * 3 * M * 4 + kWarps * M * 4 * 4;
}

// dk, dv of one 64-key tile; with kFusedDq also its share of dq.
template <int D, bool kLse, bool kFusedDq, bool kRing>
__global__ void __launch_bounds__(kThreads)
attention_bwd_kv_kernel(const AttnArgs a) {
  static_assert(!(kRing && kFusedDq), "the ring has no fused dq phase");
  static_assert(D % 16 == 0 && D <= 128, "head dim");
  using TO = std::conditional_t<kRing, float, bf16>;  // the ring partials are fp32
  constexpr int M = kv_rows<D>();
  constexpr int P = D + kPad;   // row stride of the k, v, q, do tiles
  constexpr int PS = M + kPad;  // row stride of the ds^T tile
  constexpr int NT = M / 8;     // n8 tiles of s^T, dp^T (q rows)
  constexpr int DT = D / 8;     // n8 tiles of dk, dv (dims)
  constexpr int KD = D / 16;    // k steps over the head dim
  constexpr int KM = M / 16;    // k steps over the q rows
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* sk = reinterpret_cast<bf16*>(tc_smem);
  bf16* sv = sk + kKeys * P;
  bf16* sq = sv + kKeys * P;    // [2][M][P]
  bf16* sdo = sq + 2 * M * P;   // [2][M][P]
  bf16* sds = sdo + 2 * M * P;  // [kKeys][PS]
  float* sst = reinterpret_cast<float*>(sds + (kFusedDq ? kKeys * PS : 0));  // [2][3][M]
  auto keep = reinterpret_cast<uint32_t(*)[M][4]>(sst + 2 * 3 * M);         // [kWarps]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  // global offsets of local row 0 and local key 0 (0 outside the ring)
  const int q_off = kRing ? a.q_off : 0;
  const int k_off = kRing ? a.k_off : 0;
  // this block's keys as global columns [c0, c0 + 64); key tile 0, which
  // every q tile sees, first
  const int c0 = (k_off / kKeys + blockIdx.z) * kKeys;
  const int S = a.S;
  const bf16* q = head_ptr<bf16>(a.q, b, h);
  const bf16* k = head_ptr<bf16>(a.k, b, h);
  const bf16* v = head_ptr<bf16>(a.v, b, h);
  const bf16* dout = head_ptr<bf16>(a.dout, b, h);
  const long long bh_row = static_cast<long long>(b * a.H + h) * S;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int st = max(a.start[b], 0);
  const int en = kRing ? a.end[b] : min(a.end[b], S);
  const bool drop = a.drop_threshold > 0;
  const uint32_t seed = drop ? static_cast<uint32_t>(a.seed[0]) : 0u;
  const uint32_t bh = static_cast<uint32_t>(b * a.H + h);

  load_rows<kKeys, D>(sk, k, a.k.ss, c0 - k_off, S);
  load_rows<kKeys, D>(sv, v, a.v.ss, c0 - k_off, S);
  auto load_q_tile = [&](int r0, int stage) {
    load_rows<M, D>(sq + stage * M * P, q, a.q.ss, r0, S);
    load_rows<M, D>(sdo + stage * M * P, dout, a.dout.ss, r0, S);
    float* stat = sst + stage * 3 * M;
    load_stat<M>(stat, (kLse ? a.lse : a.m) + bh_row, r0, S);
    if constexpr (!kLse) load_stat<M>(stat + M, a.l + bh_row, r0, S);
    load_stat<M>(stat + 2 * M, a.delta + bh_row, r0, S);
  };

  // rows that see a key of this tile: r >= max(c0, st), and only if the tile
  // meets [st, en)
  const bool any_key = c0 < en && c0 + kKeys > st;
  const int r_first = max(max(c0, st) - q_off, 0);  // local row
  const int r_beg = any_key ? (r_first / M) * M : S;
  if (r_beg < S) load_q_tile(r_beg, 0);
  cp_async_commit();

  float dk_acc[DT][4], dv_acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  // this lane's keys in the s^T fragments: c0 + 16 warp + g (+ 8)
  const int key0 = c0 + warp * 16 + g;
  const bf16* ak_base = a_addr(sk, P, warp * 16, 0, lane);
  const bf16* av_base = a_addr(sv, P, warp * 16, 0, lane);

  int stage = 0;
  for (int r0 = r_beg; r0 < S; r0 += M, stage ^= 1) {
    if (r0 + M < S) load_q_tile(r0 + M, stage ^ 1);
    cp_async_commit();
    if (drop) {  // the Philox block (column block c0/16 + warp, row) of each row
#pragma unroll
      for (int i = lane; i < M; i += 32)
        *reinterpret_cast<uint4*>(keep[warp][i]) = philox4x32_10(
            make_uint4(static_cast<uint32_t>(c0 / 16 + warp),
                       static_cast<uint32_t>(q_off + r0 + i), 0u, 0u),
            make_uint2(seed, bh));
    }
    cp_async_wait<1>();
    __syncthreads();  // this step's tiles (and the k, v tiles) have landed
    const bf16* tq = sq + stage * M * P;
    const bf16* tdo = sdo + stage * M * P;
    const float* stat = sst + stage * 3 * M;

    // s^T = k q^T and dp^T = v do^T: this warp's 16 keys x M rows
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t ak[4], av[4];
      ldsm(ak, ak_base + kd * 16);
      ldsm(av, av_base + kd * 16);
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t bq[4], bd[4];
        ldsm(bq, bt_addr(tq, P, nt * 8, kd * 16, lane));
        ldsm(bd, bt_addr(tdo, P, nt * 8, kd * 16, lane));
        mma(s[nt], ak, bq[0], bq[1]);
        mma(s[nt + 1], ak, bq[2], bq[3]);
        mma(dp[nt], av, bd[0], bd[1]);
        mma(dp[nt + 1], av, bd[2], bd[3]);
      }
    }

    // p * ks and ds on the fragments, rounded to bf16: the accumulator
    // fragments of n8 tiles 2kk and 2kk + 1 are the A operand of k step kk
    uint32_t ap[KM][4], ads[KM][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float y[4], d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = key0 + (e >> 1) * 8;      // global column
        const int rl = nt * 8 + 2 * t + (e & 1);  // row in the tile
        const int r = r0 + rl;                    // local row
        bool ok = col <= q_off + r && col >= st && col < en && r < S;
        if constexpr (kRing) ok = ok && col >= k_off && col < k_off + S;
        float inv_l = 1.f;
        if constexpr (!kLse) {
          const float l = stat[M + rl];
          inv_l = l > 0.f ? 1.f / l : 0.f;
        }
        const float p = ok ? exp2f((s[nt][e] * a.sm_scale - stat[rl]) * kLog2e) * inv_l : 0.f;
        float ks = 1.f;
        if (drop)
          ks = byte_of(keep[warp][rl][(g >> 2) + 2 * (e >> 1)], g & 3) >= a.drop_threshold
                   ? a.drop_scale
                   : 0.f;
        y[e] = p * ks;
        d[e] = p * (dp[nt][e] * ks - stat[2 * M + rl]) * a.sm_scale;
      }
      const int kk = nt >> 1, hi = (nt & 1) * 2;
      ap[kk][hi] = pack_bf16(y[0], y[1]);
      ap[kk][hi + 1] = pack_bf16(y[2], y[3]);
      ads[kk][hi] = pack_bf16(d[0], d[1]);
      ads[kk][hi + 1] = pack_bf16(d[2], d[3]);
      if constexpr (kFusedDq) {  // ds^T [key][row] for the dq product
        bf16* dst = sds + (warp * 16 + g) * PS + nt * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(dst) = ads[kk][hi];
        *reinterpret_cast<uint32_t*>(dst + 8 * PS) = ads[kk][hi + 1];
      }
    }

    // dv += (p ks)^T do, dk += ds^T q
#pragma unroll
    for (int kk = 0; kk < KM; ++kk) {
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {
        uint32_t bd[4], bq[4];
        ldsm_t(bd, b_addr(tdo, P, kk * 16, dt * 8, lane));
        ldsm_t(bq, b_addr(tq, P, kk * 16, dt * 8, lane));
        mma(dv_acc[dt], ap[kk], bd[0], bd[1]);
        mma(dv_acc[dt + 1], ap[kk], bd[2], bd[3]);
        mma(dk_acc[dt], ads[kk], bq[0], bq[1]);
        mma(dk_acc[dt + 1], ads[kk], bq[2], bq[3]);
      }
    }

    if constexpr (kFusedDq) {
      // dq[rows] += ds k over this block's 64 keys, added into the fp32
      // scratch (the blocks of the other key tiles add into the same rows).
      // Warps split the M x D product into M/16 row groups x the rest.
      __syncthreads();  // every warp's ds^T is in sds
      constexpr int RG = M / 16, CG = kWarps / RG, DTW = DT / CG;
      static_assert(DTW % 2 == 0, "dq columns a warp");
      const int rg = warp % RG, n0 = (warp / RG) * DTW * 8;
      float acc[DTW][4];
#pragma unroll
      for (int i = 0; i < DTW; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        uint32_t ad[4];
        ldsm_t(ad, at_addr(sds, PS, kk * 16, rg * 16, lane));
#pragma unroll
        for (int dt = 0; dt < DTW; dt += 2) {
          uint32_t bk[4];
          ldsm_t(bk, b_addr(sk, P, kk * 16, n0 + dt * 8, lane));
          mma(acc[dt], ad, bk[0], bk[1]);
          mma(acc[dt + 1], ad, bk[2], bk[3]);
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = r0 + rg * 16 + g + 8 * hh;
        if (r < r_first || r >= S) continue;  // ds = 0 before r_first
        float* dst = a.dq_acc + (bh_row + r) * D + n0 + 2 * t;
#pragma unroll
        for (int dt = 0; dt < DTW; ++dt)  // sm_90's vector atomics: one for two values
          atomicAdd(reinterpret_cast<float2*>(dst + dt * 8),
                    make_float2(acc[dt][2 * hh], acc[dt][2 * hh + 1]));
      }
    }
    __syncthreads();  // this stage (and ds^T) are free for the next step
  }
  cp_async_wait<0>();

  TO* dk = head_ptr<TO>(a.dk, b, h);
  TO* dv = head_ptr<TO>(a.dv, b, h);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int cl = key0 + 8 * hh - k_off;  // local key
    if (cl < 0 || cl >= S) continue;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      store2(&dk[cl * a.dk.ss + dt * 8 + 2 * t], dk_acc[dt][2 * hh], dk_acc[dt][2 * hh + 1]);
      store2(&dv[cl * a.dv.ss + dt * 8 + 2 * t], dv_acc[dt][2 * hh], dv_acc[dt][2 * hh + 1]);
    }
  }
}

template <int D>
__host__ __device__ constexpr int dq_smem_bytes() {
  constexpr int P = D + kPad;
  // q, do [kRows][P]; k, v [2 stages][kKeys][P]; keep words [kWarps][16][16]
  return (2 * kRows * P + 4 * kKeys * P) * 2 + kWarps * 16 * 16 * 4;
}

// dq of one 64-row q tile, over the 64-key tiles at or below the diagonal.
template <int D, bool kLse, bool kRing>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const AttnArgs a) {
  static_assert(D % 16 == 0 && D <= 128, "head dim");
  using TO = std::conditional_t<kRing, float, bf16>;  // the ring partial is fp32
  constexpr int P = D + kPad;
  constexpr int kHalf = kKeys / 2;  // keys a pass over s, dp takes: half the tile
  constexpr int NT = kHalf / 8;     // n8 tiles of s, dp (keys) a pass
  constexpr int DT = D / 8;         // n8 tiles of dq (dims)
  constexpr int KD = D / 16;        // k steps over the head dim
  constexpr int KK = kHalf / 16;    // k steps over the keys a pass
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* sq = reinterpret_cast<bf16*>(tc_smem);
  bf16* sdo = sq + kRows * P;
  bf16* sk = sdo + kRows * P;      // [2][kKeys][P]
  bf16* sv = sk + 2 * kKeys * P;   // [2][kKeys][P]
  auto keep = reinterpret_cast<uint32_t(*)[16][16]>(sv + 2 * kKeys * P);  // [kWarps]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int r0 = (gridDim.z - 1 - blockIdx.z) * kRows;  // heaviest q tile first
  const int S = a.S;
  const bf16* q = head_ptr<bf16>(a.q, b, h);
  const bf16* k = head_ptr<bf16>(a.k, b, h);
  const bf16* v = head_ptr<bf16>(a.v, b, h);
  const bf16* dout = head_ptr<bf16>(a.dout, b, h);
  const long long bh_row = static_cast<long long>(b * a.H + h) * S;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  // global offsets of local row 0 and local key 0 (0 outside the ring)
  const int q_off = kRing ? a.q_off : 0;
  const int k_off = kRing ? a.k_off : 0;
  const int st = max(a.start[b], 0);
  const int en = kRing ? a.end[b] : min(a.end[b], S);
  // the key tiles this q tile sees, as global columns
  const int c_end = min(min(en, k_off + S), q_off + min(r0 + kRows, S));
  const int c_beg = (max(st, k_off) / kKeys) * kKeys;
  const bool drop = a.drop_threshold > 0;
  const uint32_t seed = drop ? static_cast<uint32_t>(a.seed[0]) : 0u;
  const uint32_t bh = static_cast<uint32_t>(b * a.H + h);

  load_rows<kRows, D>(sq, q, a.q.ss, r0, S);
  load_rows<kRows, D>(sdo, dout, a.dout.ss, r0, S);
  auto load_kv = [&](int c, int stage) {
    load_rows<kKeys, D>(sk + stage * kKeys * P, k, a.k.ss, c - k_off, S);
    load_rows<kKeys, D>(sv + stage * kKeys * P, v, a.v.ss, c - k_off, S);
  };
  if (c_beg < c_end) load_kv(c_beg, 0);
  cp_async_commit();

  // this lane's rows: r0 + 16 warp + g (+ 8)
  const int row0 = r0 + warp * 16 + g;
  float mrow[2], inv_l[2], delta[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + 8 * hh;
    mrow[hh] = inv_l[hh] = delta[hh] = 0.f;
    if (r < S) {
      row_stats<kLse>(a, bh_row + r, mrow[hh], inv_l[hh]);
      delta[hh] = a.delta[bh_row + r];
    }
  }
  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  const bf16* aq_base = a_addr(sq, P, warp * 16, 0, lane);
  const bf16* ad_base = a_addr(sdo, P, warp * 16, 0, lane);

  int stage = 0;
  for (int c0 = c_beg; c0 < c_end; c0 += kKeys, stage ^= 1) {
    if (c0 + kKeys < c_end) load_kv(c0 + kKeys, stage ^ 1);
    cp_async_commit();
    if (drop) {  // the 16 rows x 4 column blocks of this warp's fragments
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int d = lane + 32 * i, rw = d >> 2, blk = d & 3;
        *reinterpret_cast<uint4*>(&keep[warp][rw][4 * blk]) = philox4x32_10(
            make_uint4(static_cast<uint32_t>(c0 / 16 + blk),
                       static_cast<uint32_t>(q_off + r0 + warp * 16 + rw), 0u, 0u),
            make_uint2(seed, bh));
      }
    }
    cp_async_wait<1>();
    __syncthreads();  // this key tile (and the q, do tiles) have landed
    const bf16* tk = sk + stage * kKeys * P;
    const bf16* tv = sv + stage * kKeys * P;

    // two passes of 32 keys, so that s and dp of a pass (32 fp32 registers)
    // leave room for dq's accumulators without spilling
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n0 = half * kHalf;  // the pass's first key in the tile
      // s = q k^T, dp = do v^T: this warp's 16 rows x 32 keys
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t aq[4], ad[4];
        ldsm(aq, aq_base + kd * 16);
        ldsm(ad, ad_base + kd * 16);
#pragma unroll
        for (int nt = 0; nt < NT; nt += 2) {
          uint32_t bk[4], bv[4];
          ldsm(bk, bt_addr(tk, P, n0 + nt * 8, kd * 16, lane));
          ldsm(bv, bt_addr(tv, P, n0 + nt * 8, kd * 16, lane));
          mma(s[nt], aq, bk[0], bk[1]);
          mma(s[nt + 1], aq, bk[2], bk[3]);
          mma(dp[nt], ad, bv[0], bv[1]);
          mma(dp[nt + 1], ad, bv[2], bv[3]);
        }
      }

      // ds on the fragments, rounded to bf16: the A operand of dq += ds k
      uint32_t ads[KK][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int ntt = half * NT + nt;  // n8 tile in the 64-key tile
        float d[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1;
          const int r = row0 + 8 * hh;                    // local row
          const int col = c0 + ntt * 8 + 2 * t + (e & 1);  // global column
          bool ok = col <= q_off + r && col >= st && col < en && r < S;
          if constexpr (kRing) ok = ok && col >= k_off && col < k_off + S;
          const float p =
              ok ? exp2f((s[nt][e] * a.sm_scale - mrow[hh]) * kLog2e) * inv_l[hh] : 0.f;
          float ks = 1.f;
          if (drop)
            ks = byte_of(keep[warp][g + 8 * hh][2 * ntt + (t >> 1)], 2 * (t & 1) + (e & 1)) >=
                         a.drop_threshold
                     ? a.drop_scale
                     : 0.f;
          d[e] = p * (dp[nt][e] * ks - delta[hh]) * a.sm_scale;
        }
        ads[nt >> 1][(nt & 1) * 2] = pack_bf16(d[0], d[1]);
        ads[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(d[2], d[3]);
      }
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
#pragma unroll
        for (int dt = 0; dt < DT; dt += 2) {
          uint32_t bk[4];
          ldsm_t(bk, b_addr(tk, P, n0 + kk * 16, dt * 8, lane));
          mma(acc[dt], ads[kk], bk[0], bk[1]);
          mma(acc[dt + 1], ads[kk], bk[2], bk[3]);
        }
      }
    }
    __syncthreads();  // this stage is free for the next key tile
  }
  cp_async_wait<0>();

  TO* dq = head_ptr<TO>(a.dq, b, h);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + 8 * hh;
    if (r >= S) continue;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      store2(&dq[r * a.dq.ss + dt * 8 + 2 * t], acc[dt][2 * hh], acc[dt][2 * hh + 1]);
  }
}

}  // namespace tc

template <typename T, int D, bool kLse, bool kFusedDq, bool kRing>
cudaError_t launch_kv(const AttnArgs& a, cudaStream_t stream) {
  constexpr bool kTc = std::is_same_v<T, __nv_bfloat16>;
  constexpr int kKeys = kTc ? tc::kKeys : f32::kBlockN;
  size_t smem;
  cudaError_t err;
  void (*kernel)(const AttnArgs);
  if constexpr (kTc) {
    smem = tc::kv_smem_bytes<D, kFusedDq>();
    kernel = tc::attention_bwd_kv_kernel<D, kLse, kFusedDq, kRing>;
  } else {
    smem = f32::kv_smem_floats<D>() * sizeof(float);
    kernel = f32::attention_bwd_kv_kernel_fp32<T, D, kLse, kFusedDq, kRing>;
  }
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  // the key tiles, aligned in global columns, that meet [k_off, k_off + S)
  const int k_off = kRing ? a.k_off : 0;
  const int tiles = (k_off + a.S + kKeys - 1) / kKeys - k_off / kKeys;
  kernel<<<dim3(a.H, a.B, tiles), kTc ? tc::kThreads : f32::kWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D, bool kLse, bool kRing>
cudaError_t launch_dq(const AttnArgs& a, cudaStream_t stream) {
  constexpr bool kTc = std::is_same_v<T, __nv_bfloat16>;
  constexpr int kRows = kTc ? tc::kRows : f32::kBlockM;
  size_t smem;
  void (*kernel)(const AttnArgs);
  if constexpr (kTc) {
    smem = tc::dq_smem_bytes<D>();
    kernel = tc::attention_bwd_dq_kernel<D, kLse, kRing>;
  } else {
    smem = f32::dq_smem_floats<D>() * sizeof(float);
    kernel = f32::attention_bwd_dq_kernel_fp32<T, D, kLse, kRing>;
  }
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.H, a.B, (a.S + kRows - 1) / kRows), kTc ? tc::kThreads : f32::kWarps * 32,
           smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace bwd

// Which backward tiles a launch runs, in order.
enum BwdPass { kKv = 1, kKvFusedDq = 2, kDq = 4 };

template <int kPasses, bool kLse, bool kRing, typename T, int D>
cudaError_t launch_bwd(const AttnArgs& a, cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  if constexpr ((kPasses & kKv) != 0) err = bwd::launch_kv<T, D, kLse, false, kRing>(a, stream);
  if constexpr ((kPasses & kKvFusedDq) != 0)
    if (err == cudaSuccess) err = bwd::launch_kv<T, D, kLse, true, kRing>(a, stream);
  if constexpr ((kPasses & kDq) != 0)
    if (err == cudaSuccess) err = bwd::launch_dq<T, D, kLse, kRing>(a, stream);
  return err;
}

// Head dims: bf16 16, 32, 64, 128 (the tensor-core tiles); fp32 32, 64, 128.
template <int kPasses, bool kLse, bool kRing, typename T>
cudaError_t bwd_dispatch_d(const AttnArgs& a, cudaStream_t stream) {
  switch (a.D) {
    case 16:
      if constexpr (std::is_same_v<T, __nv_bfloat16>)
        return launch_bwd<kPasses, kLse, kRing, T, 16>(a, stream);
      return cudaErrorInvalidValue;
    case 32: return launch_bwd<kPasses, kLse, kRing, T, 32>(a, stream);
    case 64: return launch_bwd<kPasses, kLse, kRing, T, 64>(a, stream);
    case 128: return launch_bwd<kPasses, kLse, kRing, T, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The passes on the arguments' dtype (0 = float32, 1 = bfloat16) and head
// dim; needs q, k, v, dout, delta and the row stats kLse names (lse, or m
// and l; the other unset), and seed when dropout is on.  kRing: the ring
// partials (global offsets, fp32 outputs).
template <int kPasses, bool kLse, bool kRing = false>
int attention_bwd(const AttnArgs* a, void* stream) {
  if (a->B <= 0 || a->H <= 0 || a->S <= 0) return cudaSuccess;
  const bool lse = a->lse != nullptr, ml = a->m != nullptr && a->l != nullptr;
  if (a->delta == nullptr || lse != kLse || ml == kLse) return cudaErrorInvalidValue;
  if (a->drop_threshold > 0 && a->seed == nullptr) return cudaErrorInvalidValue;
  if ((kPasses & kKvFusedDq) && a->dq_acc == nullptr) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a->dtype) {
    case 0: return bwd_dispatch_d<kPasses, kLse, kRing, float>(*a, s);
    case 1:
      for (const View* v : {&a->q, &a->k, &a->v, &a->dout})
        if (!tc::aligned(*v, 16, 8)) return cudaErrorMisalignedAddress;
      for (const View* v : {&a->dq, &a->dk, &a->dv})
        if (!tc::aligned(*v, 8, 2)) return cudaErrorMisalignedAddress;
      return bwd_dispatch_d<kPasses, kLse, kRing, __nv_bfloat16>(*a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
