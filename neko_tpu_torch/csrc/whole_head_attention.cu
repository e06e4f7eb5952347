// Whole-head causal attention forward, with dropout, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU Pallas kernels neko_tpu/ops/attention_kernel.py::_fwd_kernel
// (#1, [B,H,S,D], via _pallas_fwd) and ::_fwd_kernel_bsd (#3, head-packed
// [B,S,H*D], via _pallas_fwd_bsd):
//
//   p[r,c] = softmax_c( q[r,:] . k[c,:] * sm_scale ) over keys c with
//            c <= r and start[b] <= c < end[b]; fp32 softmax
//   out[r,:] = sum_c p[r,c] * keep_scale[r,c] * v[c,:]
//
// Layout: every tensor is a strided [B, H, S, D] view (attention_common.cuh),
// so one kernel serves both TPU kernels' layouts and the train path reads q,
// k, v straight out of the [B, S, 3*H*D] projection output.  start, end are
// int32 [B]; the dropout seed is an int32 on the device (no host sync).
//
// The TPU kernels keep a whole head's S x S score matrix in VMEM and cut it
// into causal bands; a block here has at most 227 KB of shared memory, so this
// is the tiled online-softmax form: one block per (64-row q tile, head,
// batch), looping over 32-key tiles in shared memory, with a running max m,
// sum l and fp32 accumulator per row.  Key tiles wholly above the diagonal or
// outside [start, end) are never loaded.  Dropout multiplies the
// unnormalized exp(s - m) that enters the accumulator, not l, so
// out = (sum_c p*keep*v) / l is the dropout of the normalized probabilities.
// When lse is non-null the kernel writes m + log(l) per row for the backward
// (the TPU kernel recomputes everything instead).
//
// What bounds it on the H100: at the flagship train shape (B=16, H=24,
// S=1024, D=32) the causal half is about 26 GFLOP per layer and the q/k/v/out
// traffic about 100 MB: small for both the 989 TFLOP/s bf16 tensor cores and
// the 3.35 TB/s HBM.  This version computes on the CUDA cores in fp32 (no
// mma/wgmma, no TMA), so shared-memory reads and FMA issue bound it, plus ~40
// integer ops per 16 keep bytes when dropout is on; tensor cores are later
// work.
//
// Fill and empty rows: masked logits take the finite fill -1e30 and masked
// probabilities are forced to exactly 0, so a row whose visited key set is
// empty keeps l = 0 and writes 0 (and lse 0), never NaN.
//
// C interface (loaded with ctypes): returns the cudaError_t of the launch.

#include "attention_common.cuh"

namespace {

using namespace whk;

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
whole_head_attention_fwd_kernel(const AttnArgs a) {
  static_assert(D % 32 == 0, "head dim must be a multiple of 32");
  constexpr int kDL = D / 32;  // output dims per lane
  constexpr int kKP = D + 1;   // padded k row stride
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + kBlockM * D;
  float* sv = sk + kBlockN * kKP;
  __shared__ uint32_t keep_words[kWarps][kRowsPerWarp][kBlockN / 4];

  const int r0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int S = a.S;
  const T* __restrict__ q = head_ptr<T>(a.q, b, h);
  const T* __restrict__ k = head_ptr<T>(a.k, b, h);
  const T* __restrict__ v = head_ptr<T>(a.v, b, h);
  T* __restrict__ out = head_ptr<T>(a.o, b, h);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int st = max(a.start[b], 0);
  const int en = min(a.end[b], S);
  const int r_end = min(r0 + kBlockM, S);
  // keys this q tile can see: [st, min(en, r_end)) -- causal bound col <= row
  const int c_end = min(en, r_end);
  const int c_beg = (st / kBlockN) * kBlockN;
  constexpr bool drop = kDrop;
  const uint32_t seed = drop ? static_cast<uint32_t>(a.seed[0]) : 0u;
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
    if constexpr (drop) draw_keep_words(keep_words[warp], seed, bh, r0 + row0, c0, lane);
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
      l[i] = l[i] * alpha + warp_sum(p[i]);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kDL; ++j) acc[i][j] *= alpha;
      if constexpr (drop)
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
    if (a.lse != nullptr && lane == 0)
      a.lse[static_cast<long long>(b * a.H + h) * S + r] = l[i] > 0.f ? m[i] + logf(l[i]) : 0.f;
  }
}

template <typename T, int D, bool kDrop>
cudaError_t launch(const AttnArgs& a, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  auto kernel = whole_head_attention_fwd_kernel<T, D, kDrop>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + kBlockM - 1) / kBlockM, a.H, a.B);
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  All tensor pointers are device pointers.
extern "C" int whole_head_attention_fwd(const AttnArgs* a, void* stream) {
  if (a->B <= 0 || a->H <= 0 || a->S <= 0) return cudaSuccess;
  if (a->drop_threshold > 0 && a->seed == nullptr) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a->dtype) {
    case 0: return dispatch_drop<float>(*a, s);
    case 1: return dispatch_drop<__nv_bfloat16>(*a, s);
    default: return cudaErrorInvalidValue;
  }
}
