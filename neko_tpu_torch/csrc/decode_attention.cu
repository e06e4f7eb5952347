// Decode-step cache attention, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel neko_tpu/ops/decode_attention.py::_kernel
// (#14, via decode_cache_attention): one query per (batch row, head) against
// the KV cache rows j with mask[b, j] set, start[b] <= j < end[b], with fp32
// scores, an fp32 softmax and the fp32 value sum; one output row in the
// query's dtype.  The caches are only read (the TPU kernel passes them
// through identity-aliased).  The window [start, end) is the range of work
// (the first to the last valid row); the mask skips the rows inside it that
// are not valid, as neko_tpu's decode step masks them (its bias over the
// whole cache mask), so a cache whose valid rows have holes attends to the
// valid ones alone.
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
// The fill of a key outside the window or the mask is finite (-1e30, never
// -inf), and a row with no key (start >= end, or no mask bit set in the
// window) writes zeros, never NaN.  The key loop visits
// only [start, end), so a short window costs only its own rows.  One block
// per (b, h) leaves most SMs idle at B=1 (24 blocks on 132 SMs); splitting the
// keys over blocks is later work.
//
// The int8 cache (ModelConfig.kv_cache_dtype='int8'; neko_tpu's
// `_quant_cache_attention`, an XLA path there, models/transformer.py:60-90):
// keys and values are int8 rows with one fp32 scale a row (ks, vs: [B, H, S]).
// The same kernel, instantiated on int8 rows: 16 bytes a lane are 16 int8
// values, dequantized in registers (never a dequantized copy of the cache),
// the score q.k_int8 * sm_scale * ks[j] and the value sum of p * vs[j] *
// v_int8[j] in fp32, p in fp32 where neko_tpu rounds p * vs to the
// activation dtype.  At B=8, H=24, S=1024, hd=32 it reads 12.6 MB of rows and
// 1.6 MB of scales a layer: 4.2 us at 3.35 TB/s.
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
  const uint8_t* mask;  // bool [B, S] valid cache rows, row stride mask_sb; null: all
  long long mask_sb;
  int B, H, S, D, dtype;  // dtype of q and o: 0 = float32, 1 = bfloat16
  float sm_scale;
  int int8_cache;  // 1: k, v are int8 rows with fp32 row scales ks, vs
  View ks, vs;     // [B, H, S] fp32 (ss unused: the rows are contiguous)
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

template <> struct Vec<int8_t> {
  static constexpr int N = 16;
  __device__ __forceinline__ static uint4 load(const int8_t* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ static void unpack(const uint4& r, float* x) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        x[4 * i + k] = static_cast<float>(static_cast<int8_t>((w[i] >> (8 * k)) & 0xffu));
    }
  }
};

// N consecutive values of type T as floats, from 16-byte loads
template <typename T, int N>
__device__ __forceinline__ void load_floats(const T* p, float* x) {
  constexpr int P = Vec<T>::N;
  static_assert(N % P == 0, "a lane's columns are whole 16-byte loads of q");
#pragma unroll
  for (int i = 0; i < N / P; ++i) Vec<T>::unpack(Vec<T>::load(p + i * P), x + i * P);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// T: q and o; C: the cache rows (T, or int8_t with row scales)
template <typename T, typename C, int D>
__global__ void __launch_bounds__(kWarps * 32) decode_attention_kernel(const DecodeArgs a) {
  constexpr bool kInt8 = sizeof(C) == 1;
  constexpr int VEC = Vec<C>::N;  // a lane's columns: 16 bytes of a cache row
  constexpr int LPK = D / VEC;    // lanes that cover one row
  constexpr int KPW = 32 / LPK;   // rows a warp covers in one load
  constexpr int STRIDE = kWarps * KPW;
  static_assert(LPK >= 1 && LPK <= 32 && 32 % LPK == 0, "hd / (16 bytes) must divide 32");
  __shared__ float sm_m[kWarps], sm_l[kWarps], sm_acc[kWarps][D];

  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane / LPK, sub = lane % LPK;
  const int s0 = max(a.start[b], 0), e0 = min(a.end[b], a.S);
  const uint8_t* valid = a.mask == nullptr ? nullptr : a.mask + b * a.mask_sb;

  float q[VEC];
  load_floats<T, VEC>(static_cast<const T*>(a.q.ptr) + b * a.q.sb + h * a.q.sh + sub * VEC, q);
#pragma unroll
  for (int e = 0; e < VEC; ++e) q[e] *= a.sm_scale * kLog2e;  // scores in the log2 domain
  const C* kbase = static_cast<const C*>(a.k.ptr) + b * a.k.sb + h * a.k.sh + sub * VEC;
  const C* vbase = static_cast<const C*>(a.v.ptr) + b * a.v.sb + h * a.v.sh + sub * VEC;
  // int8 rows: the row scales of this (b, h)
  const float* ksb = kInt8 ? static_cast<const float*>(a.ks.ptr) + b * a.ks.sb + h * a.ks.sh
                           : nullptr;
  const float* vsb = kInt8 ? static_cast<const float*>(a.vs.ptr) + b * a.vs.sb + h * a.vs.sh
                           : nullptr;

  float m = kNeg, l = 0.f, acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;

  // `base` is the same for every lane of a warp, so all lanes run the same
  // iterations and the shuffles below see the whole warp
  for (int base = s0 + warp * KPW; base < e0; base += STRIDE * kUnroll) {
    uint4 kr[kUnroll], vr[kUnroll];
    float ksc[kUnroll], vsc[kUnroll];
    bool ok[kUnroll];
    // the rows of the window are loaded whatever their mask bit, so the
    // mask's loads overlap the rows' instead of gating them
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + grp + u * STRIDE;
      ok[u] = j < e0;
      if (ok[u]) {
        kr[u] = Vec<C>::load(kbase + static_cast<long long>(j) * a.k.ss);
        vr[u] = Vec<C>::load(vbase + static_cast<long long>(j) * a.v.ss);
        if constexpr (kInt8) {
          ksc[u] = __ldg(ksb + j);
          vsc[u] = __ldg(vsb + j);
        }
      }
    }
    if (valid != nullptr) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) ok[u] = ok[u] && __ldg(valid + base + grp + u * STRIDE);
    }
    float s[kUnroll], tile_max = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float dot = 0.f;
      if (ok[u]) {
        float x[VEC];
        Vec<C>::unpack(kr[u], x);
#pragma unroll
        for (int e = 0; e < VEC; ++e) dot += q[e] * x[e];
      }
#pragma unroll
      for (int off = LPK / 2; off > 0; off >>= 1)  // sum over the row's lanes
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if constexpr (kInt8) dot *= ok[u] ? ksc[u] : 0.f;  // the key row's scale
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
      Vec<C>::unpack(vr[u], x);
      l += p;
      float pv = p;
      if constexpr (kInt8) pv *= vsc[u];  // the value row's scale
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] += pv * x[e];
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

template <typename T, typename C>
cudaError_t launch_d(const DecodeArgs& a, cudaStream_t stream) {
  const dim3 grid(a.B * a.H), block(kWarps * 32);
  switch (a.D) {
    case 16: decode_attention_kernel<T, C, 16><<<grid, block, 0, stream>>>(a); break;
    case 32: decode_attention_kernel<T, C, 32><<<grid, block, 0, stream>>>(a); break;
    case 64: decode_attention_kernel<T, C, 64><<<grid, block, 0, stream>>>(a); break;
    case 128: decode_attention_kernel<T, C, 128><<<grid, block, 0, stream>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const DecodeArgs& a, cudaStream_t stream) {
  if (a.int8_cache) {
    if (a.ks.ptr == nullptr || a.vs.ptr == nullptr) return cudaErrorInvalidValue;
    return launch_d<T, int8_t>(a, stream);
  }
  return launch_d<T, T>(a, stream);
}

}  // namespace

extern "C" int decode_cache_attention(const DecodeArgs* a, void* stream) {
  if (a->B <= 0 || a->H <= 0) return cudaSuccess;
  if (a->start == nullptr || a->end == nullptr || a->S <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a->dtype) {
    case 0: return launch_t<float>(*a, s);
    case 1: return launch_t<__nv_bfloat16>(*a, s);
    default: return cudaErrorInvalidValue;
  }
}
