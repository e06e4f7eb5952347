// Decode-step cache attention, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel neko_tpu/ops/decode_attention.py::_kernel
// (#14, via decode_cache_attention): one query per (batch row, head) against
// the KV cache rows start[b] <= j < end[b], with fp32 scores, an fp32 softmax
// and the fp32 value sum; one output row in the query's dtype.  The caches
// are only read (the TPU kernel passes them through identity-aliased).
//
// What bounds it on the H100: every valid key row is read once from K and
// once from V, and each byte meets ~1 FLOP (a dot product and an axpy per
// row of hd values), so HBM bandwidth: at B=8, H=24, S=1024, hd=32 bf16 that
// is 25.2 MB a layer, 7.5 us at 3.35 TB/s.  The TPU kernel copies a head
// group's whole cache slice to VMEM and then computes; here nothing is
// staged: one block per (b, h) streams the rows straight into registers.
// Each warp lane loads 16 bytes of a key row and the same 16 bytes of its
// value row (hd / (16 bytes) lanes cover a row, so a warp covers 32 * 16 /
// (hd * elt) neighbouring rows in one coalesced load), four rows per lane
// group are in flight at once, and each lane group keeps its own online
// softmax (running max, sum, fp32 accumulator of its slice of hd).  The
// groups merge by warp shuffles, the warps through shared memory.
//
// The fill of a key outside the window is finite (-1e30, never -inf), and a
// row with no key (start >= end) writes zeros, never NaN.  The key loop visits
// only [start, end), so a short window costs only its own rows.  One block
// per (b, h) leaves most SMs idle at B=1 (24 blocks on 132 SMs); splitting the
// keys over blocks is later work.
//
// C interface (loaded with ctypes): returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

struct View {
  void* ptr;
  long long sb, sh, ss;  // batch, head, row strides (elements); hd is contiguous
};

struct DecodeArgs {
  View q, k, v, o;  // q, o: [B, H, hd] (ss unused); k, v: [B, H, S, hd]
  const int* start;
  const int* end;
  int B, H, S, D, dtype;  // dtype: 0 = float32, 1 = bfloat16
  float sm_scale;
};

namespace {

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 8;
constexpr int kUnroll = 4;  // key rows a lane group has in flight

// 16 bytes of a row as floats
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static uint4 load(const float* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ static void unpack(const uint4& r, float* x) {
    x[0] = __uint_as_float(r.x); x[1] = __uint_as_float(r.y);
    x[2] = __uint_as_float(r.z); x[3] = __uint_as_float(r.w);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static uint4 load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ static void unpack(const uint4& r, float* x) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a bf16 is the top half of an fp32
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32) decode_attention_kernel(const DecodeArgs a) {
  constexpr int VEC = Vec<T>::N;
  constexpr int LPK = D / VEC;    // lanes that cover one row
  constexpr int KPW = 32 / LPK;   // rows a warp covers in one load
  constexpr int STRIDE = kWarps * KPW;
  static_assert(LPK >= 1 && LPK <= 32 && 32 % LPK == 0, "hd / (16 bytes) must divide 32");
  __shared__ float sm_m[kWarps], sm_l[kWarps], sm_acc[kWarps][D];

  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane / LPK, sub = lane % LPK;
  const int s0 = max(a.start[b], 0), e0 = min(a.end[b], a.S);

  float q[VEC];
  Vec<T>::unpack(Vec<T>::load(static_cast<const T*>(a.q.ptr) + b * a.q.sb + h * a.q.sh +
                              sub * VEC), q);
#pragma unroll
  for (int e = 0; e < VEC; ++e) q[e] *= a.sm_scale * kLog2e;  // scores in the log2 domain
  const T* kbase = static_cast<const T*>(a.k.ptr) + b * a.k.sb + h * a.k.sh + sub * VEC;
  const T* vbase = static_cast<const T*>(a.v.ptr) + b * a.v.sb + h * a.v.sh + sub * VEC;

  float m = kNeg, l = 0.f, acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;

  // `base` is the same for every lane of a warp, so all lanes run the same
  // iterations and the shuffles below see the whole warp
  for (int base = s0 + warp * KPW; base < e0; base += STRIDE * kUnroll) {
    uint4 kr[kUnroll], vr[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + grp + u * STRIDE;
      ok[u] = j < e0;
      if (ok[u]) {
        kr[u] = Vec<T>::load(kbase + static_cast<long long>(j) * a.k.ss);
        vr[u] = Vec<T>::load(vbase + static_cast<long long>(j) * a.v.ss);
      }
    }
    float s[kUnroll], tile_max = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float dot = 0.f;
      if (ok[u]) {
        float x[VEC];
        Vec<T>::unpack(kr[u], x);
#pragma unroll
        for (int e = 0; e < VEC; ++e) dot += q[e] * x[e];
      }
#pragma unroll
      for (int off = LPK / 2; off > 0; off >>= 1)  // sum over the row's lanes
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      s[u] = ok[u] ? dot : kNeg;
      tile_max = fmaxf(tile_max, s[u]);
    }
    const float alpha = exp2f(m - tile_max);
    l *= alpha;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] *= alpha;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!ok[u]) continue;
      const float p = exp2f(s[u] - tile_max);
      float x[VEC];
      Vec<T>::unpack(vr[u], x);
      l += p;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] += p * x[e];
    }
    m = tile_max;
  }

  // merge the lane groups of the warp (every lane ends with the warp's total)
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1) {
    const float m_o = __shfl_xor_sync(0xffffffffu, m, off);
    const float l_o = __shfl_xor_sync(0xffffffffu, l, off);
    const float mn = fmaxf(m, m_o), ca = exp2f(m - mn), cb = exp2f(m_o - mn);
    l = l * ca + l_o * cb;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float acc_o = __shfl_xor_sync(0xffffffffu, acc[e], off);
      acc[e] = acc[e] * ca + acc_o * cb;
    }
    m = mn;
  }
  if (grp == 0) {
    if (sub == 0) { sm_m[warp] = m; sm_l[warp] = l; }
#pragma unroll
    for (int e = 0; e < VEC; ++e) sm_acc[warp][sub * VEC + e] = acc[e];
  }
  __syncthreads();
  // merge the warps: one thread per output element
  if (threadIdx.x < D) {
    float mx = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w]);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = exp2f(sm_m[w] - mx);
      lt += sm_l[w] * c;
      at += sm_acc[w][threadIdx.x] * c;
    }
    store(static_cast<T*>(a.o.ptr) + b * a.o.sb + h * a.o.sh + threadIdx.x,
          lt > 0.f ? at / lt : 0.f);
  }
}

template <typename T>
cudaError_t launch_d(const DecodeArgs& a, cudaStream_t stream) {
  const dim3 grid(a.B * a.H), block(kWarps * 32);
  switch (a.D) {
    case 32: decode_attention_kernel<T, 32><<<grid, block, 0, stream>>>(a); break;
    case 64: decode_attention_kernel<T, 64><<<grid, block, 0, stream>>>(a); break;
    case 128: decode_attention_kernel<T, 128><<<grid, block, 0, stream>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int decode_cache_attention(const DecodeArgs* a, void* stream) {
  if (a->B <= 0 || a->H <= 0) return cudaSuccess;
  if (a->start == nullptr || a->end == nullptr || a->S <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a->dtype) {
    case 0: return launch_d<float>(*a, s);
    case 1: return launch_d<__nv_bfloat16>(*a, s);
    default: return cudaErrorInvalidValue;
  }
}
