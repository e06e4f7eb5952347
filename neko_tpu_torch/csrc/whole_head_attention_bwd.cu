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
//   2. dk, dv: attention_bwd.cuh's kv tile, one block per key tile, looping
//      over the query tiles at or below the diagonal;
//   3. dq: its dq tile, one block per query tile, looping over the keys in
//      [start, min(end, row_end)).
// dq, dk and dv are strided views like the inputs, so the train path writes
// them straight into one [B, S, 3*H*hd] gradient buffer.
//
// What bounds it on the H100: the backward recomputes q k^T and do v^T (once
// in each of kernels 2 and 3) and forms dq, dk, dv: 14 * hd FLOPs per
// visible (row, key) pair, operations-bound at the flagship shape.  In bf16
// every product runs on the tensor cores (mma.sync, attention_bwd.cuh),
// with the elementwise work of each score kept in registers; fp32 runs the
// CUDA-core tiles.
//
// C interface (loaded with ctypes): returns the first failing cudaError_t.

#include "attention_bwd.cuh"

namespace {

constexpr int kDeltaWarps = 8;

// delta[b, h, r] = sum_d do[r, d] * out[r, d]: one warp per row.
template <typename T>
__global__ void __launch_bounds__(kDeltaWarps * 32)
attention_bwd_delta_kernel(const AttnArgs a) {
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * kDeltaWarps + threadIdx.x / 32;
  if (row >= static_cast<long long>(a.B) * a.H * a.S) return;
  const int r = static_cast<int>(row % a.S);
  const int bh = static_cast<int>(row / a.S);
  const int b = bh / a.H, h = bh % a.H;
  const T* o = head_ptr<T>(a.o, b, h) + r * a.o.ss;
  const T* dout = head_ptr<T>(a.dout, b, h) + r * a.dout.ss;
  float sum = 0.f;
  for (int d = lane; d < a.D; d += 32) sum += to_f32(o[d]) * to_f32(dout[d]);
  sum = warp_sum(sum);
  if (lane == 0) a.delta[row] = sum;
}

template <typename T>
cudaError_t launch_delta(const AttnArgs& a, cudaStream_t stream) {
  const long long rows = static_cast<long long>(a.B) * a.H * a.S;
  const unsigned grid = static_cast<unsigned>((rows + kDeltaWarps - 1) / kDeltaWarps);
  attention_bwd_delta_kernel<T><<<grid, kDeltaWarps * 32, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Needs q, k, v, o, dout, dq, dk, dv, lse
// and the delta scratch (m, l unset); all tensor pointers are device pointers.
extern "C" int whole_head_attention_bwd(const AttnArgs* a, void* stream) {
  if (a->B <= 0 || a->H <= 0 || a->S <= 0) return cudaSuccess;
  if (a->lse == nullptr || a->m != nullptr || a->delta == nullptr) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (a->dtype) {
    case 0: err = launch_delta<float>(*a, s); break;
    case 1: err = launch_delta<__nv_bfloat16>(*a, s); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return attention_bwd<kKv | kDq, true>(a, stream);
}
