// Whole-head causal attention forward, with dropout, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU Pallas kernels neko_tpu/ops/attention_kernel.py::_fwd_kernel
// (#1, [B,H,S,D], via _pallas_fwd) and ::_fwd_kernel_bsd (#3, head-packed
// [B,S,H*D], via _pallas_fwd_bsd): causal softmax attention over the keys
// start[b] <= c < end[b], dropout on the probabilities.
//
// Layout: every tensor is a strided [B, H, S, D] view (attention_common.cuh),
// so one kernel serves both TPU kernels' layouts and the train path reads q,
// k, v straight out of the [B, S, 3*H*D] projection output.  start, end are
// int32 [B]; the dropout seed is an int32 on the device (no host sync).
//
// The TPU kernels keep a whole head's S x S score matrix in VMEM and cut it
// into causal bands; a block here has at most 227 KB of shared memory, so this
// is the tiled online-softmax kernel of attention_fwd.cuh (shared with the
// blocked forward, #6).  When lse is non-null it writes m + log(l) per row
// for the backward (the TPU kernel recomputes everything instead).
//
// What bounds it on the H100: at the flagship train shape (B=16, H=24,
// S=1024, D=32) the causal half is about 26 GFLOP per layer and the q/k/v/out
// traffic about 100 MB: small for both the 989 TFLOP/s bf16 tensor cores and
// the 3.35 TB/s HBM.  This version computes on the CUDA cores in fp32 (no
// mma/wgmma, no TMA), so shared-memory reads and FMA issue bound it, plus ~40
// integer ops per 16 keep bytes when dropout is on; tensor cores are later
// work.
//
// C interface (loaded with ctypes): returns the cudaError_t of the launch.

#include "attention_fwd.cuh"

// dtype: 0 = float32, 1 = bfloat16.  Needs q, k, v, o (lse optional; m, l
// unset); all tensor pointers are device pointers.
extern "C" int whole_head_attention_fwd(const AttnArgs* a, void* stream) {
  if (a->m != nullptr) return cudaErrorInvalidValue;
  return attention_fwd(a, stream);
}
