// The causal attention forward that whole_head_attention.cu (#1, #3) and
// blocked_attention.cu (#6) launch: one kernel, two row-stat contracts.
//
//   p[r,c] = softmax_c( q[r,:] . k[c,:] * sm_scale ) over keys c with
//            c <= r and start[b] <= c < end[b]; fp32 softmax
//   out[r,:] = sum_c p[r,c] * keep_scale[r,c] * v[c,:]
//
// Row stats, per the pointers set in AttnArgs: lse = m + log(l) for the
// whole-head backward, or the running max m and the normalizer l (without
// the keep mask) for the blocked backward; with neither, none is written
// (the serving prefill).
//
// Tiling: the tiled online-softmax form.  One block per (64-row q tile, head,
// batch) loops over 32-key tiles in shared memory, a warp per 8 rows and a
// lane per key, with a running max m, sum l and an fp32 accumulator per row.
// Key tiles wholly above the diagonal or outside [start, end) are never
// loaded.  Dropout multiplies the unnormalized exp(s - m) that enters the
// accumulator, not l, so out = (sum_c p*keep*v) / l is the dropout of the
// normalized probabilities.
//
// Causal imbalance: the last q tile visits S / 32 key tiles and the first one.
// The q tile is the slowest grid dimension, reversed, so the blocks of the
// heaviest tiles (of every head and batch row) start first and the light
// ones fill the tail.
//
// Fill and empty rows: masked logits take the finite fill -1e30 and masked
// probabilities are forced to exactly 0, so a row whose visited key set is
// empty keeps l = 0 and writes o = 0, lse = 0, m = -1e30 and l = 0, never NaN.

#pragma once

#include "attention_common.cuh"

namespace {

using namespace whk;

namespace fwd {

constexpr int kBlockM = 64;  // query rows per block
constexpr int kBlockN = 32;  // keys per tile (one key per lane)
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = kBlockM / kWarps;

template <int D>
constexpr int smem_floats() {
  // q tile [kBlockM][D], k tile [kBlockN][D + 1] (padded: lane j reads row j
  // with no bank conflict), v tile [kBlockN][D]
  return kBlockM * D + kBlockN * (D + 1) + kBlockN * D;
}

// kDrop: dropout on.  The serving prefill runs the instantiation without it,
// which carries no Philox code and no keep-mask registers.
// At D = 32 four blocks share an SM (at most 64 registers a thread, a few
// spilled): on an H100 that measured 16% faster at the train shape and as
// fast at the prefill as three blocks with 76 registers.
template <typename T, int D, bool kDrop>
__global__ void __launch_bounds__(kWarps * 32, D == 32 ? 4 : 1)
attention_fwd_kernel(const AttnArgs a) {
  static_assert(D % 32 == 0, "head dim must be a multiple of 32");
  constexpr int kDL = D / 32;  // output dims per lane
  constexpr int kKP = D + 1;   // padded k row stride
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + kBlockM * D;
  float* sv = sk + kBlockN * kKP;
  __shared__ uint32_t keep_words[kWarps][kRowsPerWarp][kBlockN / 4];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int r0 = (gridDim.z - 1 - blockIdx.z) * kBlockM;  // heaviest q tile first
  const int S = a.S;
  const T* __restrict__ q = head_ptr<T>(a.q, b, h);
  const T* __restrict__ k = head_ptr<T>(a.k, b, h);
  const T* __restrict__ v = head_ptr<T>(a.v, b, h);
  T* __restrict__ out = head_ptr<T>(a.o, b, h);
  const long long bh_row = static_cast<long long>(b * a.H + h) * S;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int st = max(a.start[b], 0);
  const int en = min(a.end[b], S);
  // keys this q tile can see: [st, min(en, r_end)) -- causal bound col <= row
  const int c_end = min(en, min(r0 + kBlockM, S));
  const int c_beg = (st / kBlockN) * kBlockN;
  const uint32_t seed = kDrop ? static_cast<uint32_t>(a.seed[0]) : 0u;
  const uint32_t bh = static_cast<uint32_t>(b * a.H + h);

  for (int i = tid; i < kBlockM * D; i += blockDim.x) {
    const int r = r0 + i / D;
    sq[i] = r < S ? load(&q[r * a.q.ss + i % D]) : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDL];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDL; ++j) acc[i][j] = 0.f;
  }
  const int row0 = warp * kRowsPerWarp;  // this warp's first row in the tile

  for (int c0 = c_beg; c0 < c_end; c0 += kBlockN) {
    __syncthreads();  // previous tile fully consumed (and q tile written)
    for (int i = tid; i < kBlockN * D; i += blockDim.x) {
      const int c = c0 + i / D, d = i % D;
      float kx = 0.f, vx = 0.f;
      if (c < S) {  // one branch for both loads, so their latencies overlap
        kx = load(&k[c * a.k.ss + d]);
        vx = load(&v[c * a.v.ss + d]);
      }
      sk[(i / D) * kKP + d] = kx;
      sv[i] = vx;
    }
    if constexpr (kDrop) draw_keep_words(keep_words[warp], seed, bh, r0 + row0, c0, lane);
    __syncthreads();

    const int c = c0 + lane;  // this lane's key
    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kd = sk[lane * kKP + d];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) s[i] = fmaf(sq[(row0 + i) * D + d], kd, s[i]);
    }

    float p[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = r0 + row0 + i;
      const bool ok = c <= r && c >= st && c < en && r < S;
      const float si = ok ? s[i] * a.sm_scale : kNeg;
      const float m_new = fmaxf(m[i], warp_max(si));
      p[i] = ok ? expf(si - m_new) : 0.f;
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + warp_sum(p[i]);  // l before the keep mask
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kDL; ++j) acc[i][j] *= alpha;
      if constexpr (kDrop)
        p[i] = keep_byte(keep_words[warp], i, lane) >= a.drop_threshold ? p[i] * a.drop_scale
                                                                         : 0.f;
    }

#pragma unroll 4
    for (int j = 0; j < kBlockN; ++j) {
      float vj[kDL];
#pragma unroll
      for (int t = 0; t < kDL; ++t) vj[t] = sv[j * D + lane + 32 * t];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float pj = __shfl_sync(0xffffffffu, p[i], j);
#pragma unroll
        for (int t = 0; t < kDL; ++t) acc[i][t] = fmaf(pj, vj[t], acc[i][t]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = r0 + row0 + i;
    if (r >= S) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int t = 0; t < kDL; ++t) store(&out[r * a.o.ss + lane + 32 * t], acc[i][t] * inv);
    if (lane == 0) {
      if (a.lse != nullptr) a.lse[bh_row + r] = l[i] > 0.f ? m[i] + logf(l[i]) : 0.f;
      if (a.m != nullptr) {
        a.m[bh_row + r] = m[i];
        a.l[bh_row + r] = l[i];
      }
    }
  }
}

template <typename T, int D, bool kDrop>
cudaError_t launch(const AttnArgs& a, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  auto kernel = attention_fwd_kernel<T, D, kDrop>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.H, a.B, (a.S + kBlockM - 1) / kBlockM);
  kernel<<<grid, kWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool kDrop>
cudaError_t dispatch_d(const AttnArgs& a, cudaStream_t stream) {
  switch (a.D) {
    case 32: return launch<T, 32, kDrop>(a, stream);
    case 64: return launch<T, 64, kDrop>(a, stream);
    case 128: return launch<T, 128, kDrop>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_drop(const AttnArgs& a, cudaStream_t stream) {
  return a.drop_threshold > 0 ? dispatch_d<T, true>(a, stream) : dispatch_d<T, false>(a, stream);
}

}  // namespace fwd

// The forward on the arguments' dtype (0 = float32, 1 = bfloat16).
inline int attention_fwd(const AttnArgs* a, void* stream) {
  if (a->B <= 0 || a->H <= 0 || a->S <= 0) return cudaSuccess;
  if (a->drop_threshold > 0 && a->seed == nullptr) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a->dtype) {
    case 0: return fwd::dispatch_drop<float>(*a, s);
    case 1: return fwd::dispatch_drop<__nv_bfloat16>(*a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
