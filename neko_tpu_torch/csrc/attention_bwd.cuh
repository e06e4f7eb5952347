// The causal attention backward tiles that whole_head_attention_bwd.cu (#2,
// #4) and blocked_attention_bwd.cu (#7, #8, #9) launch.  With ks the
// keep/scale the forward applied (attention_common.cuh) and delta =
// rowsum(do * o) computed before the launch:
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
// Hopper blocks run in parallel in no order, and no block holds a full-S
// fp32 dk/dv (96 KB per head at S = 8192, D = 128, next to the tiles, in
// 227 KB), so the TPU's scheme -- dk/dv resident across a sequential grid --
// does not carry over.  Instead:
//
// * kv: one block per (32-key tile, head, batch) keeps its dk and dv in
//   registers and loops over the 64-row q tiles from the diagonal down.  For
//   each (q, k) tile it computes s, p, dp and the keep mask once.  With
//   kFusedDq it also adds ds k into an fp32 dq scratch [B, H, S, D] with
//   atomicAdd (zeroed before the launch, cast into dq after it): 5 tile
//   products where kv + dq take 7, for 64 x D atomics per tile pair.  The
//   atomics make dq's summation order change from run to run.
// * dq: one block per 64-row q tile loops over the key tiles at or below the
//   diagonal and owns its dq rows: no atomics, deterministic.
//
// Causal imbalance: key tile 0 sees every q tile and the last q tile sees
// every key tile, so the tile index is the slowest grid dimension, ordered so
// that the heaviest blocks start first (key tiles ascending, q tiles
// descending).
//
// Offsets: batch and head offsets and the rows of the row stats, delta and
// the dq scratch are 64-bit.

#pragma once

#include "attention_common.cuh"

namespace {

using namespace whk;

namespace bwd {

constexpr int kBlockM = 64;  // query rows per tile
constexpr int kBlockN = 32;  // keys per tile (one key per lane)
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = kBlockM / kWarps;
constexpr int kPP = kBlockN + 1;  // padded row stride of the p / ds tiles

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

template <int D>
constexpr int kv_smem_floats() {
  // k, v tiles [kBlockN][D + 1]; q, do tiles [kBlockM][D]; p*ks and ds
  // tiles [kBlockM][kBlockN + 1]; m, 1/l, delta [kBlockM]
  return 2 * kBlockN * (D + 1) + 2 * kBlockM * D + 2 * kBlockM * kPP + 3 * kBlockM;
}

// dk, dv of one key tile; with kFusedDq also its share of dq.
template <typename T, int D, bool kLse, bool kFusedDq>
__global__ void __launch_bounds__(kWarps * 32)
attention_bwd_kv_kernel(const AttnArgs a) {
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
  const int c0 = blockIdx.z * kBlockN;  // key tile 0, which every q tile sees, first
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
  const int en = min(a.end[b], S);
  const bool drop = a.drop_threshold > 0;
  const uint32_t seed = drop ? static_cast<uint32_t>(a.seed[0]) : 0u;
  const uint32_t bh = static_cast<uint32_t>(b * a.H + h);

  for (int i = tid; i < kBlockN * D; i += blockDim.x) {
    const int c = c0 + i / D, d = i % D;
    float kx = 0.f, vx = 0.f;
    if (c < S) {  // one branch for both loads, so their latencies overlap
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
  const int r_first = max(c0, st);
  const int r_beg = any_key ? (r_first / kBlockM) * kBlockM : S;
  const int c = c0 + lane;  // this lane's key in phase A

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
    if (drop) draw_keep_words(keep_words[warp], seed, bh, r0 + row0, c0, lane);
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
      const bool ok = c <= r && c >= st && c < en && r < S;
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

  T* dk = head_ptr<T>(a.dk, b, h);
  T* dv = head_ptr<T>(a.dv, b, h);
#pragma unroll
  for (int j = 0; j < kKeysPerWarp; ++j) {
    const int cj = c0 + warp + kWarps * j;
    if (cj >= S) continue;
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
template <typename T, int D, bool kLse>
__global__ void __launch_bounds__(kWarps * 32)
attention_bwd_dq_kernel(const AttnArgs a) {
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
  const int st = max(a.start[b], 0);
  const int en = min(a.end[b], S);
  const int c_end = min(en, min(r0 + kBlockM, S));
  const int c_beg = (st / kBlockN) * kBlockN;
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
      const int c = c0 + i / D, d = i % D;
      float kx = 0.f, vx = 0.f;
      if (c < S) {  // one branch for both loads, so their latencies overlap
        kx = load(&k[c * a.k.ss + d]);
        vx = load(&v[c * a.v.ss + d]);
      }
      sk[(i / D) * kKP + d] = kx;
      sv[(i / D) * kKP + d] = vx;
    }
    if (drop) draw_keep_words(keep_words[warp], seed, bh, r0 + row0, c0, lane);
    __syncthreads();

    const int c = c0 + lane;
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
      const bool ok = c <= r && c >= st && c < en && r < S;
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

  T* dq = head_ptr<T>(a.dq, b, h);
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = r0 + row0 + i;
    if (r >= S) continue;
#pragma unroll
    for (int t = 0; t < kDL; ++t) store(&dq[r * a.dq.ss + lane + 32 * t], acc[i][t]);
  }
}

template <typename T, int D, bool kLse, bool kFusedDq>
cudaError_t launch_kv(const AttnArgs& a, cudaStream_t stream) {
  const size_t smem = kv_smem_floats<D>() * sizeof(float);
  auto kernel = attention_bwd_kv_kernel<T, D, kLse, kFusedDq>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.H, a.B, (a.S + kBlockN - 1) / kBlockN), kWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D, bool kLse>
cudaError_t launch_dq(const AttnArgs& a, cudaStream_t stream) {
  const size_t smem = dq_smem_floats<D>() * sizeof(float);
  auto kernel = attention_bwd_dq_kernel<T, D, kLse>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.H, a.B, (a.S + kBlockM - 1) / kBlockM), kWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace bwd

// Which backward tiles a launch runs, in order.
enum BwdPass { kKv = 1, kKvFusedDq = 2, kDq = 4 };

template <int kPasses, bool kLse, typename T, int D>
cudaError_t launch_bwd(const AttnArgs& a, cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  if constexpr ((kPasses & kKv) != 0) err = bwd::launch_kv<T, D, kLse, false>(a, stream);
  if constexpr ((kPasses & kKvFusedDq) != 0)
    if (err == cudaSuccess) err = bwd::launch_kv<T, D, kLse, true>(a, stream);
  if constexpr ((kPasses & kDq) != 0)
    if (err == cudaSuccess) err = bwd::launch_dq<T, D, kLse>(a, stream);
  return err;
}

template <int kPasses, bool kLse, typename T>
cudaError_t bwd_dispatch_d(const AttnArgs& a, cudaStream_t stream) {
  switch (a.D) {
    case 32: return launch_bwd<kPasses, kLse, T, 32>(a, stream);
    case 64: return launch_bwd<kPasses, kLse, T, 64>(a, stream);
    case 128: return launch_bwd<kPasses, kLse, T, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The passes on the arguments' dtype (0 = float32, 1 = bfloat16) and head
// dim; needs q, k, v, dout, delta and the row stats kLse names (lse, or m
// and l; the other unset), and seed when dropout is on.
template <int kPasses, bool kLse>
int attention_bwd(const AttnArgs* a, void* stream) {
  if (a->B <= 0 || a->H <= 0 || a->S <= 0) return cudaSuccess;
  const bool lse = a->lse != nullptr, ml = a->m != nullptr && a->l != nullptr;
  if (a->delta == nullptr || lse != kLse || ml == kLse) return cudaErrorInvalidValue;
  if (a->drop_threshold > 0 && a->seed == nullptr) return cudaErrorInvalidValue;
  if ((kPasses & kKvFusedDq) && a->dq_acc == nullptr) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a->dtype) {
    case 0: return bwd_dispatch_d<kPasses, kLse, float>(*a, s);
    case 1: return bwd_dispatch_d<kPasses, kLse, __nv_bfloat16>(*a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
