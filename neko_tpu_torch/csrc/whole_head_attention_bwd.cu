// Whole-head causal attention backward, with dropout, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU Pallas kernels neko_tpu/ops/attention_kernel.py::_bwd_kernel
// (#2, [B,H,S,D], via _pallas_bwd) and ::_bwd_kernel_bsd (#4, head-packed, via
// _pallas_bwd_bsd).  The math is `_blk_grads` (attention_kernel.py:153-166),
// with p recomputed from q, k and the forward's log-sum-exp and ks the same
// keep/scale the forward applied (attention_common.cuh):
//
//   p  = exp(s * sm_scale - lse)       (0 where masked)
//   dv = (p * ks)^T do
//   dp = (do v^T) * ks
//   delta = rowsum(dp * p) = rowsum(do * out)
//   ds = p * (dp - delta) * sm_scale
//   dq = ds k,  dk = ds^T q
//
// The TPU kernel runs one program per (batch, head) over the whole S x S
// matrix and adds into dk/dv as it walks its causal bands.  Blocks on Hopper
// run in parallel in no order, so this backward is three launches and uses
// no atomics (the result is deterministic):
//   1. delta per row from do and out (the JAX package's blocked backward
//      also computes it outside its kernel, blocked_attention.py:645-651);
//   2. dk, dv: one block per (32-key tile, head, batch), looping over the
//      64-row query tiles at or below the diagonal;
//   3. dq: one block per (64-row query tile, head, batch), looping over the
//      keys in [start, min(end, row_end)).
// dq, dk and dv are strided views like the inputs, so the train path writes
// them straight into one [B, S, 3*H*D] gradient buffer.
//
// What bounds it on the H100: the backward recomputes q k^T and do v^T (once
// in each of kernels 2 and 3) and forms dq, dk, dv: about 3.5x the forward's
// FLOPs, all on the CUDA cores in fp32 through shared memory, like the
// forward.  Tensor cores are later work.
//
// C interface (loaded with ctypes): returns the first failing cudaError_t.

#include "attention_common.cuh"

namespace {

using namespace whk;

constexpr int kBlockM = 64;  // query rows per tile
constexpr int kBlockN = 32;  // keys per tile (one key per lane)
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = kBlockM / kWarps;
constexpr int kPP = kBlockN + 1;  // padded row stride of the p / ds tiles

// delta[b, h, r] = sum_d do[r, d] * out[r, d]: one warp per row.
template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
whole_head_attention_bwd_delta_kernel(const AttnArgs a) {
  constexpr int kDL = D / 32;
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (row >= static_cast<long long>(a.B) * a.H * a.S) return;
  const int r = static_cast<int>(row % a.S);
  const int bh = static_cast<int>(row / a.S);
  const int b = bh / a.H, h = bh % a.H;
  const T* o = head_ptr<T>(a.o, b, h) + r * a.o.ss;
  const T* dout = head_ptr<T>(a.dout, b, h) + r * a.dout.ss;
  float sum = 0.f;
#pragma unroll
  for (int t = 0; t < kDL; ++t) sum += to_f32(o[lane + 32 * t]) * to_f32(dout[lane + 32 * t]);
  sum = warp_sum(sum);
  if (lane == 0) a.delta[row] = sum;
}

template <int D>
constexpr int dkdv_smem_floats() {
  // k, v tiles [kBlockN][D + 1]; q, do tiles [kBlockM][D]; p*ks and ds
  // tiles [kBlockM][kBlockN + 1]; lse, delta [kBlockM]
  return 2 * kBlockN * (D + 1) + 2 * kBlockM * D + 2 * kBlockM * kPP + 2 * kBlockM;
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
whole_head_attention_bwd_dkdv_kernel(const AttnArgs a) {
  constexpr int kDL = D / 32;
  constexpr int kKP = D + 1;
  constexpr int kKeysPerWarp = kBlockN / kWarps;  // 4: keys warp + 8m
  extern __shared__ float smem[];
  float* sk = smem;
  float* sv = sk + kBlockN * kKP;
  float* sq = sv + kBlockN * kKP;
  float* sdo = sq + kBlockM * D;
  float* sp = sdo + kBlockM * D;
  float* sds = sp + kBlockM * kPP;
  float* slse = sds + kBlockM * kPP;
  float* sdelta = slse + kBlockM;
  __shared__ uint32_t keep_words[kWarps][kRowsPerWarp][kBlockN / 4];

  const int c0 = blockIdx.x * kBlockN;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
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
  for (int m = 0; m < kKeysPerWarp; ++m) {
#pragma unroll
    for (int t = 0; t < kDL; ++t) dk_acc[m][t] = dv_acc[m][t] = 0.f;
  }

  // rows that see a key of this tile: r >= max(c0, st), and only if the tile
  // meets [st, en)
  const bool any_key = c0 < en && c0 + kBlockN > st;
  const int r_beg = any_key ? (max(c0, st) / kBlockM) * kBlockM : S;
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
      slse[tid] = r < S ? a.lse[bh_row + r] : 0.f;
      sdelta[tid] = r < S ? a.delta[bh_row + r] : 0.f;
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
      const int r = r0 + row0 + i;
      const bool ok = c <= r && c >= st && c < en && r < S;
      const float p = ok ? expf(s[i] * a.sm_scale - slse[row0 + i]) : 0.f;
      float ks = 1.f;
      if (drop) ks = keep_byte(keep_words[warp], i, lane) >= a.drop_threshold ? a.drop_scale : 0.f;
      sp[(row0 + i) * kPP + lane] = p * ks;
      sds[(row0 + i) * kPP + lane] = p * (dp[i] * ks - sdelta[row0 + i]) * a.sm_scale;
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
      for (int m = 0; m < kKeysPerWarp; ++m) {
        const float pr = sp[r * kPP + warp + kWarps * m];
        const float dsr = sds[r * kPP + warp + kWarps * m];
#pragma unroll
        for (int t = 0; t < kDL; ++t) {
          dv_acc[m][t] = fmaf(pr, dov[t], dv_acc[m][t]);
          dk_acc[m][t] = fmaf(dsr, qv[t], dk_acc[m][t]);
        }
      }
    }
  }

  T* dk = head_ptr<T>(a.dk, b, h);
  T* dv = head_ptr<T>(a.dv, b, h);
#pragma unroll
  for (int m = 0; m < kKeysPerWarp; ++m) {
    const int cj = c0 + warp + kWarps * m;
    if (cj >= S) continue;
#pragma unroll
    for (int t = 0; t < kDL; ++t) {
      store(&dk[cj * a.dk.ss + lane + 32 * t], dk_acc[m][t]);
      store(&dv[cj * a.dv.ss + lane + 32 * t], dv_acc[m][t]);
    }
  }
}

template <int D>
constexpr int dq_smem_floats() {
  // q, do tiles [kBlockM][D]; k, v tiles [kBlockN][D + 1]
  return 2 * kBlockM * D + 2 * kBlockN * (D + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
whole_head_attention_bwd_dq_kernel(const AttnArgs a) {
  constexpr int kDL = D / 32;
  constexpr int kKP = D + 1;
  extern __shared__ float smem[];
  float* sq = smem;
  float* sdo = sq + kBlockM * D;
  float* sk = sdo + kBlockM * D;
  float* sv = sk + kBlockN * kKP;
  __shared__ uint32_t keep_words[kWarps][kRowsPerWarp][kBlockN / 4];

  const int r0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
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
  float lse[kRowsPerWarp], delta[kRowsPerWarp], acc[kRowsPerWarp][kDL];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = r0 + row0 + i;
    lse[i] = r < S ? a.lse[bh_row + r] : 0.f;
    delta[i] = r < S ? a.delta[bh_row + r] : 0.f;
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
      const float p = ok ? expf(s[i] * a.sm_scale - lse[i]) : 0.f;
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

template <typename T, int D>
cudaError_t launch(const AttnArgs& a, cudaStream_t stream) {
  const long long rows = static_cast<long long>(a.B) * a.H * a.S;
  whole_head_attention_bwd_delta_kernel<T, D>
      <<<static_cast<unsigned>((rows + kWarps - 1) / kWarps), kWarps * 32, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_kv = dkdv_smem_floats<D>() * sizeof(float);
  auto dkdv = whole_head_attention_bwd_dkdv_kernel<T, D>;
  if ((err = allow_smem(dkdv, smem_kv)) != cudaSuccess) return err;
  dkdv<<<dim3((a.S + kBlockN - 1) / kBlockN, a.H, a.B), kWarps * 32, smem_kv, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t smem_q = dq_smem_floats<D>() * sizeof(float);
  auto dq = whole_head_attention_bwd_dq_kernel<T, D>;
  if ((err = allow_smem(dq, smem_q)) != cudaSuccess) return err;
  dq<<<dim3((a.S + kBlockM - 1) / kBlockM, a.H, a.B), kWarps * 32, smem_q, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const AttnArgs& a, cudaStream_t stream) {
  switch (a.D) {
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Needs q, k, v, o, dout, dq, dk, dv, lse
// and the delta scratch; all tensor pointers are device pointers.
extern "C" int whole_head_attention_bwd(const AttnArgs* a, void* stream) {
  if (a->B <= 0 || a->H <= 0 || a->S <= 0) return cudaSuccess;
  if (a->lse == nullptr || a->delta == nullptr) return cudaErrorInvalidValue;
  if (a->drop_threshold > 0 && a->seed == nullptr) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a->dtype) {
    case 0: return dispatch_d<float>(*a, s);
    case 1: return dispatch_d<__nv_bfloat16>(*a, s);
    default: return cudaErrorInvalidValue;
  }
}
