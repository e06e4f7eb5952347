// Ring attention, one (local q block, visiting kv block) pair per launch, with
// dropout, for NVIDIA Hopper (sm_90a): the per-pair kernels of the
// sequence-parallel forward and backward passes.
//
// Replaces the TPU Pallas kernels of neko_tpu/ops/ring_kernel.py:
//   #11 _ring_fwd_kernel (via _partial_fwd) -> ring_attention_fwd
//   #12 _ring_dq_kernel  (via _partial_dq)  -> ring_attention_dq
//   #13 _ring_dkv_kernel (via _partial_dkv) -> ring_attention_dkv
// The sequence is cut into shards of S rows.  A launch sees the q rows of one
// shard, at global row offset q_off, and the keys of one shard, at global
// column offset k_off, and computes over the keys col <= row (global) with
// start[b] <= col < end[b] (global):
//
//   #11  m[r]   = max_c s[r, c],  l[r] = sum_c exp(s[r, c] - m[r])
//        acc[r] = sum_c exp(s[r, c] - m[r]) * ks[r, c] * v[c]     (fp32, NOT / l)
//   #12  dq[r]  = sum_c ds[r, c] k[c]                              (fp32)
//   #13  dk[c]  = sum_r ds[r, c] q[r],  dv[c] = sum_r p[r, c] ks[r, c] do[r]
//        with p = exp(s - L[r]), ds = p * (dp * ks - delta[r]) * sm_scale
//
// from the log-sum-exp L = m + log(l) of the whole ring and delta =
// rowsum(do * o), both computed outside.  The caller merges the (m, l, acc)
// partials of a row over the kv blocks and adds up the gradient partials
// (neko_tpu_torch/ops/ring_kernel.py), as the JAX package does in XLA.
//
// These are the tiles of attention_fwd.cuh and attention_bwd.cuh in their
// ring mode: global rows and columns in the causal test, the key window and
// the Philox counter, so the keep byte of (seed, b, h, row, col) is the one
// the blocked kernels draw at the same S, whichever ring step computes the
// pair; fp32 outputs; the log-sum-exp row stats of the whole-head backward;
// and in #13 the block that gets gradients is the visiting one.  Key tiles
// start at global multiples of the tile width, so the offsets need no
// alignment.
//
// The TPU kernel is launched for every pair and ends at once on a kv block
// that lies wholly in the future of the q block.  Here the offsets are host
// integers, so the caller skips those launches.
//
// What bounds them on the H100: a full (past) pair at B = 2, H = 24, S = 2048,
// hd = 32 is 25.8 GFLOP in #11 (0.026 ms at the 989 TFLOP/s bf16 tensor-core
// rate) against 32 MB of traffic (q, k, v in bf16, the fp32 acc, m, l: 0.010
// ms at 3.35 TB/s): operations.  In bf16 all three run their products on
// the tensor cores (the tc tiles of attention_fwd.cuh and attention_bwd.cuh).
//
// Rows that see no key of the pair write acc = 0, m = -1e30, l = 0 and have
// p = 0 in the backward: nothing is NaN, and merging such a partial changes
// nothing.
//
// C interface (loaded with ctypes): each entry returns the first failing
// cudaError_t.  dtype: 0 = float32, 1 = bfloat16 (of q, k, v, dout; every
// output is fp32).  All tensor pointers are device pointers.

#include "attention_bwd.cuh"
#include "attention_fwd.cuh"

namespace {

bool offsets_ok(const AttnArgs* a) { return a->q_off >= 0 && a->k_off >= 0; }

}  // namespace

// #11: needs q, k, v, o (fp32), m, l (lse unset; seed when dropout is on).
extern "C" int ring_attention_fwd(const AttnArgs* a, void* stream) {
  if (a->m == nullptr || a->l == nullptr || a->lse != nullptr || !offsets_ok(a))
    return cudaErrorInvalidValue;
  return attention_fwd<true>(a, stream);
}

// #12: needs q, k, v, dout, lse, delta; writes dq (fp32).
extern "C" int ring_attention_dq(const AttnArgs* a, void* stream) {
  if (!offsets_ok(a)) return cudaErrorInvalidValue;
  return attention_bwd<kDq, true, true>(a, stream);
}

// #13: needs q, k, v, dout, lse, delta; writes dk, dv (fp32) of the visiting
// block.
extern "C" int ring_attention_dkv(const AttnArgs* a, void* stream) {
  if (!offsets_ok(a)) return cudaErrorInvalidValue;
  return attention_bwd<kKv, true, true>(a, stream);
}
