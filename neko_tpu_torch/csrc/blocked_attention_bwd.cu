// Blocked causal attention backward from the row stats (m, l), with dropout,
// for NVIDIA Hopper (sm_90a): the fused one-sweep route and the three-pass
// route.
//
// Replaces the TPU Pallas kernels of neko_tpu/ops/blocked_attention.py:
//   #8 _bwd_fused_kernel (via _pallas_bwd_fused)  -> blocked_attention_bwd_fused
//   #7 _dq_kernel        (via _pallas_dq)         -> blocked_attention_dq
//   #9 _dkv_kernel       (via _pallas_dkv)        -> blocked_attention_dkv
// The math is theirs: p = exp(s * sm_scale - m) / l from the forward's row
// stats, delta = rowsum(do * o) computed outside, and ks the keep/scale the
// forward applied.
//
// The tiles are those of attention_bwd.cuh, shared with the whole-head
// backward (#2, #4), on (m, l) in place of lse:
// * #9 is its kv tile: one block per key tile keeps dk and dv in registers
//   and loops over the q tiles from the diagonal down;
// * #8 is the same tile with the fused dq phase: each (q, k) tile's s, p,
//   dp and keep mask are computed once, and ds k is added into a zeroed fp32
//   dq scratch with atomics (5 tile products where #7 + #9 take 7), which
//   the wrapper casts into dq.  Hopper blocks run in no order and a full-S
//   fp32 dk/dv does not fit beside the tiles in shared memory, so the TPU's
//   dk/dv resident across a sequential grid does not carry over;
// * #7 is its dq tile: one block per q tile owns its dq rows, no atomics.
//
// What bounds it on the H100: at the k = 2048 train shape (B = 8, H = 24,
// D = 32) the fused backward's 5 products are about 129 GFLOP, 0.13 ms at the
// 989 TFLOP/s bf16 tensor-core rate; its traffic (q, k, v, do, dq, dk, dv,
// m, l, delta) about 180 MB: operations.  In bf16 the products run on the
// tensor cores (mma.sync) from cp.async-fed bf16 tiles, p and ds stay in
// registers, and the fused dq goes out as float2 atomics; fp32 runs the
// CUDA-core tiles.
//
// C interface (loaded with ctypes): each entry returns the first failing
// cudaError_t.

#include "attention_bwd.cuh"

// dtype: 0 = float32, 1 = bfloat16.  Each needs q, k, v, dout, m, l, delta
// (and seed when dropout is on; lse unset); all tensor pointers are device
// pointers.

// #9: writes dk, dv.
extern "C" int blocked_attention_dkv(const AttnArgs* a, void* stream) {
  return attention_bwd<kKv, false>(a, stream);
}

// #8: writes dk, dv and adds dq into the zeroed fp32 scratch dq_acc.
extern "C" int blocked_attention_bwd_fused(const AttnArgs* a, void* stream) {
  return attention_bwd<kKvFusedDq, false>(a, stream);
}

// #7: writes dq.
extern "C" int blocked_attention_dq(const AttnArgs* a, void* stream) {
  return attention_bwd<kDq, false>(a, stream);
}
