// Blocked causal attention forward with row stats and dropout, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel neko_tpu/ops/blocked_attention.py::_fwd_kernel
// (#6, via _pallas_fwd), the long-context forward.  Over the keys c <= r with
// start[b] <= c < end[b], with s = q[r] . k[c] * sm_scale in fp32:
//
//   m[r] = max_c s[r, c]
//   l[r] = sum_c exp(s[r, c] - m[r])                 (no keep mask in l)
//   o[r] = sum_c exp(s[r, c] - m[r]) * ks[r, c] * v[c] / l[r]
//
// m and l (fp32 [B, H, S]) are what the backward kernels
// (blocked_attention_bwd.cu) recompute p from.  ks is the keep/scale of
// element (b, h, r, c) that every attention kernel of the port applies
// (attention_common.cuh), so the mask does not depend on the tiling.
//
// The TPU kernel keeps a head group's full K and V in VMEM and walks 512 x 512
// tiles.  A Hopper block has at most 227 KB of shared memory and many blocks
// must be in flight to fill 132 SMs, so the tiles are small: this is the
// kernel of attention_fwd.cuh, the whole-head forward's (64-row q tiles,
// 32-key tiles, a warp per 8 rows and a lane per key, heaviest q tiles
// first), writing (m, l) in place of lse.  At S = 8192 the causal imbalance
// is 256 key tiles for the last q tile against 1 for the first, which the
// heaviest-first order spreads over the SMs.
//
// What bounds it on the H100: at the k = 2048 train shape (B = 8, H = 24,
// D = 32) the causal half is 51.5 GFLOP per layer and the q/k/v/o/m/l traffic
// about 103 MB, 0.052 ms at the 989 TFLOP/s bf16 tensor-core rate.  This
// version computes on the CUDA cores in fp32 (no mma/wgmma, no TMA): the
// shared-memory reads of the score loop (one per FMA per row group) and FMA
// issue bound it.  Tensor cores are later work.
//
// Rows with no visible key (before start, or start >= end) write o = 0,
// m = -1e30 and l = 0, never NaN.
//
// Offsets: batch and head offsets (b * sb, with sb = S * 3 * H * D for the
// projection slices) and row offsets of m and l are 64-bit.
//
// C interface (loaded with ctypes): returns the cudaError_t of the launch.

#include "attention_fwd.cuh"

// dtype: 0 = float32, 1 = bfloat16.  Needs q, k, v, o, m, l (and seed when
// dropout is on; lse unset); all tensor pointers are device pointers.
extern "C" int blocked_attention_fwd(const AttnArgs* a, void* stream) {
  if (a->m == nullptr || a->l == nullptr || a->lse != nullptr) return cudaErrorInvalidValue;
  return attention_fwd(a, stream);
}
