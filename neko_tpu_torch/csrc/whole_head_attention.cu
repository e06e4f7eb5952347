// Whole-head causal attention forward for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel neko_tpu/ops/attention_kernel.py::_fwd_kernel
// (reached through _pallas_fwd / whole_head_attention) at dropout_rate = 0:
//
//   out[b,h,r,:] = softmax_c( q[b,h,r,:] . k[b,h,c,:] * sm_scale ) @ v[b,h,c,:]
//   over keys c with c <= r and start[b] <= c < end[b]; fp32 softmax.
//
// Layout: q, k, v, out are contiguous [B, H, S, D] (bf16 or fp32); start and
// end are int32 [B].  The TPU kernel keeps a whole head's S x S score matrix
// in VMEM; a block here has at most 227 KB of shared memory, so this is the
// tiled online-softmax form: one block per (64-row q tile, head, batch),
// looping over 32-key tiles held in shared memory, with a running max m, sum
// l and fp32 accumulator per row.  Key tiles wholly above the diagonal or
// outside [start, end) are never loaded.
//
// What bounds it on the H100: at the flagship prefill (B=8, H=24, S=1024,
// D=32) the causal half is about 13 GFLOP and the q/k/v/out traffic about
// 50 MB per layer: tiny for both the 989 TFLOP/s bf16 tensor cores and the
// 3.35 TB/s HBM.  This first version computes on the CUDA cores in fp32
// (no mma/wgmma, no TMA), so it is bound by shared-memory reads and FMA
// throughput; tensor cores are later work.
//
// Fill and empty rows: masked logits take the finite fill -1e30 (as the TPU
// kernel does, never -inf) and masked probabilities are forced to exactly 0,
// so a row whose visited key set is empty keeps l = 0 and writes 0, not NaN.
//
// C interface (loaded with ctypes): returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kBlockM = 64;  // query rows per block
constexpr int kBlockN = 32;  // keys per tile (one key per lane)
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = kBlockM / kWarps;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr int smem_floats() {
  // q tile [kBlockM][D], k tile [kBlockN][D + 1] (padded: lane j reads row j
  // with no bank conflict), v tile [kBlockN][D]
  return kBlockM * D + kBlockN * (D + 1) + kBlockN * D;
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
whole_head_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                const T* __restrict__ v, const int* __restrict__ start,
                                const int* __restrict__ end, T* __restrict__ out,
                                int H, int S, float sm_scale) {
  static_assert(D % 32 == 0, "head dim must be a multiple of 32");
  constexpr int kDL = D / 32;  // output dims per lane
  constexpr int kKP = D + 1;   // padded k row stride
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + kBlockM * D;
  float* sv = sk + kBlockN * kKP;

  const int r0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t head = (static_cast<size_t>(b) * H + h) * static_cast<size_t>(S) * D;
  q += head;
  k += head;
  v += head;
  out += head;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int st = max(start[b], 0);
  const int en = min(end[b], S);
  const int r_end = min(r0 + kBlockM, S);
  // keys this q tile can see: [st, min(en, r_end)) -- causal bound col <= row
  const int c_end = min(en, r_end);
  const int c_beg = (st / kBlockN) * kBlockN;

  for (int i = tid; i < kBlockM * D; i += blockDim.x) {
    const int r = r0 + i / D;
    sq[i] = r < S ? to_f32(q[static_cast<size_t>(r) * D + i % D]) : 0.f;
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
      const bool in = c < S;
      const size_t off = static_cast<size_t>(c) * D + d;
      sk[(i / D) * kKP + d] = in ? to_f32(k[off]) : 0.f;
      sv[i] = in ? to_f32(v[off]) : 0.f;
    }
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
      const float si = ok ? s[i] * sm_scale : kNeg;
      const float m_new = fmaxf(m[i], warp_max(si));
      p[i] = ok ? expf(si - m_new) : 0.f;
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + warp_sum(p[i]);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kDL; ++j) acc[i][j] *= alpha;
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
    for (int t = 0; t < kDL; ++t)
      store(&out[static_cast<size_t>(r) * D + lane + 32 * t], acc[i][t] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* start,
                   const int* end, void* out, int B, int H, int S, float sm_scale,
                   cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  auto kernel = whole_head_attention_fwd_kernel<T, D>;
  // above 48 KB (D = 128) dynamic shared memory must be opted into
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBlockM - 1) / kBlockM, H, B);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      start, end, static_cast<T*>(out), H, S, sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, const int* start,
                       const int* end, void* out, int B, int H, int S, int D,
                       float sm_scale, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, start, end, out, B, H, S, sm_scale, stream);
    case 64: return launch<T, 64>(q, k, v, start, end, out, B, H, S, sm_scale, stream);
    case 128: return launch<T, 128>(q, k, v, start, end, out, B, H, S, sm_scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  All pointers are device pointers.
extern "C" int whole_head_attention_fwd(const void* q, const void* k, const void* v,
                                        const void* start, const void* end, void* out,
                                        int B, int H, int S, int D, int dtype,
                                        float sm_scale, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return cudaSuccess;
  const int* st = static_cast<const int*>(start);
  const int* en = static_cast<const int*>(end);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_d<float>(q, k, v, st, en, out, B, H, S, D, sm_scale, s);
    case 1: return dispatch_d<__nv_bfloat16>(q, k, v, st, en, out, B, H, S, D, sm_scale, s);
    default: return cudaErrorInvalidValue;
  }
}
