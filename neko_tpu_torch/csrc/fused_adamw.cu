// Fused AdamW over every parameter in one launch, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel neko_tpu/ops/fused_adamw.py::_adamw_kernel
// (#16, via _leaf_update_pallas): one elementwise pass that reads p, g, mu, nu
// and writes p, mu, nu in place (clip scale, the two moments, bias
// correction, decoupled weight decay, the apply).  The TPU kernel runs one
// grid per leaf of 65,536 elements or more, retiled and padded to
// (rows, 1024); here one launch walks a table of every leaf, large or small,
// and nothing is padded or copied.
//
// The table: int64 [n_leaves, 6] on the device, one row per leaf: the
// pointers p, g, mu, nu, the element count n and tile0, the number of
// kTile-element tiles of the leaves before it.  g = 0 means a zero gradient.
// The wrapper (ops/fused_adamw.py) rebuilds it every step, because
// zero_grad(set_to_none=True) gives every gradient new storage, and copies it
// from pinned memory on the launch stream without blocking the host (the
// table is not passed by value: 87 leaves of the flagship tree need more than
// the classic 4 KB of kernel parameters).
//
// The clip scale stays on the device and is read through a pointer (the
// global norm is torch's); lr and the reciprocals of the bias corrections are
// host floats from the step count.  So a step never syncs with the host.
//
// Every operation rounds on its own (the _rn intrinsics: no contraction into
// fused multiply-adds), in the order of the plain version
// (`_leaf_update_plain`), so the two agree to the last bit.
//
// What bounds it on the H100: 28 bytes a parameter (read p, g, mu, nu; write
// p, mu, nu) against ~20 floating-point operations, so HBM bandwidth: 3.49 GB
// for the flagship's 124.7M parameters, 1.04 ms at 3.35 TB/s.  The design does
// what a bandwidth-bound pass needs: 16-byte loads and stores where a leaf's
// four pointers are 16-byte aligned (scalar ones otherwise), neighbouring
// threads on neighbouring addresses, enough blocks resident on every SM to
// keep loads in flight, and one launch for all 87 leaves instead of one each.
//
// C interface (loaded with ctypes): returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

struct Hyper {
  float lr, b1, one_minus_b1, b2, one_minus_b2, eps, wd, inv_bc1, inv_bc2;
};

namespace {

struct Leaf {
  long long p, g, mu, nu, n, tile0;
};

constexpr int kThreads = 256;
constexpr long long kTile = 4096;  // elements a block updates at a time (16 per thread)

__device__ __forceinline__ void update(float& p, float g, float& mu, float& nu, float scale,
                                       const Hyper& h) {
  g = __fmul_rn(g, scale);
  mu = __fadd_rn(__fmul_rn(mu, h.b1), __fmul_rn(g, h.one_minus_b1));
  nu = __fadd_rn(__fmul_rn(nu, h.b2), __fmul_rn(__fmul_rn(g, g), h.one_minus_b2));
  const float upd = __fdiv_rn(__fmul_rn(mu, h.inv_bc1),
                              __fadd_rn(__fsqrt_rn(__fmul_rn(nu, h.inv_bc2)), h.eps));
  p = __fsub_rn(p, __fmul_rn(__fadd_rn(upd, __fmul_rn(p, h.wd)), h.lr));
}

__global__ void __launch_bounds__(kThreads)
fused_adamw_kernel(const Leaf* __restrict__ leaves, int n_leaves, long long n_tiles,
                   const float* __restrict__ scale_ptr, const Hyper h) {
  const float scale = *scale_ptr;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    int lo = 0, hi = n_leaves - 1;  // the last leaf whose tiles start at or before `tile`
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (leaves[mid].tile0 <= tile) lo = mid; else hi = mid - 1;
    }
    const Leaf L = leaves[lo];
    float* p = reinterpret_cast<float*>(L.p);
    const float* g = reinterpret_cast<const float*>(L.g);
    float* mu = reinterpret_cast<float*>(L.mu);
    float* nu = reinterpret_cast<float*>(L.nu);
    const long long base = (tile - L.tile0) * kTile;
    const long long end = base + kTile < L.n ? base + kTile : L.n;
    long long scalar_from = base;
    if (((L.p | L.g | L.mu | L.nu) & 15) == 0) {
      for (long long i = base + 4 * threadIdx.x; i + 3 < end; i += 4 * kThreads) {
        float4 pv = *reinterpret_cast<const float4*>(p + i);
        float4 mv = *reinterpret_cast<const float4*>(mu + i);
        float4 vv = *reinterpret_cast<const float4*>(nu + i);
        const float4 gv = g ? *reinterpret_cast<const float4*>(g + i) : make_float4(0, 0, 0, 0);
        update(pv.x, gv.x, mv.x, vv.x, scale, h);
        update(pv.y, gv.y, mv.y, vv.y, scale, h);
        update(pv.z, gv.z, mv.z, vv.z, scale, h);
        update(pv.w, gv.w, mv.w, vv.w, scale, h);
        *reinterpret_cast<float4*>(p + i) = pv;
        *reinterpret_cast<float4*>(mu + i) = mv;
        *reinterpret_cast<float4*>(nu + i) = vv;
      }
      scalar_from = base + ((end - base) & ~3LL);  // the last 0-3 elements of the leaf
    }
    for (long long i = scalar_from + threadIdx.x; i < end; i += kThreads) {
      float pv = p[i], mv = mu[i], vv = nu[i];
      update(pv, g ? g[i] : 0.f, mv, vv, scale, h);
      p[i] = pv;
      mu[i] = mv;
      nu[i] = vv;
    }
  }
}

}  // namespace

// table: the device int64 [n_leaves, 6] table above, tiles counted with
// `tile` elements each (the wrapper's constant; it must equal kTile);
// n_tiles: the total; scale: fp32 scalar on the device.
extern "C" int fused_adamw(const void* table, int n_leaves, long long n_tiles, long long tile,
                           const float* scale, const Hyper* h, void* stream) {
  if (n_leaves <= 0 || n_tiles <= 0) return cudaSuccess;
  if (table == nullptr || scale == nullptr || h == nullptr || tile != kTile)
    return cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long blocks = n_tiles < 8LL * sms ? n_tiles : 8LL * sms;
  fused_adamw_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Leaf*>(table), n_leaves, n_tiles, scale, *h);
  return cudaGetLastError();
}
