// Shared by the attention kernels: whole-head (forward, backward, keep mask)
// and blocked (forward with row stats, fused and three-pass backward).
//
// AttnArgs is the one argument block every C entry point takes, passed from
// Python as a ctypes Structure (neko_tpu_torch/ops/attention_kernel.py
// `_Args`, field for field).  Every tensor is a [B, H, S, D] view given by a
// pointer and its (batch, head, sequence) strides in elements; D is
// contiguous.  The same code then serves contiguous [B, H, S, D] tensors and
// head-packed [B, S, H*D] ones, including the three column slices of one
// [B, S, 3*H*D] projection output (sequence stride 3*H*D).
//
// Dropout keep mask: the keep byte of element (b, h, row, col) is byte
// (col % 16) of the 16-byte Philox4x32-10 output at counter
// (col / 16, row, 0, 0) under key (seed, b * H + h).  It depends on
// (seed, b, h, row, col) alone, so the layout and the tiling never change it;
// `keep_bytes_reference` in attention_kernel.py is the same generator in
// plain torch.  An element is kept when its byte is >= drop_threshold
// (= min(round(rate * 256), 255); 0 disables dropout) and then scaled by
// drop_scale = 1 / (1 - threshold / 256).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

struct View {
  void* ptr;
  long long sb, sh, ss;  // batch, head, sequence strides (elements)
};

struct AttnArgs {
  View q, k, v, o, dout, dq, dk, dv;
  float* lse;     // fp32 [B, H, S] contiguous, or null (forward: not needed)
  float* delta;   // fp32 [B, H, S] contiguous scratch (backward)
  const int* start;
  const int* end;
  const int* seed;  // int32 [1] on the device; read only when dropout is on
  int B, H, S, D, dtype, drop_threshold;
  float sm_scale, drop_scale;
  // the blocked kernels (blocked_attention*.cu): row stats m (running max of
  // the scaled logits) and l (softmax normalizer, without the keep mask),
  // fp32 [B, H, S] contiguous; the fused backward's fp32 [B, H, S, D]
  // contiguous dq scratch, zeroed before its launch
  float* m;
  float* l;
  float* dq_acc;
};

namespace whk {

constexpr float kNeg = -1e30f;  // finite fill for masked logits (never -inf)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
// through the read-only data cache: the kernels never write what they load
__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(__ldg(p)); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T>
__device__ __forceinline__ T* head_ptr(const View& v, int b, int h) {
  return static_cast<T*>(v.ptr) + b * v.sb + h * v.sh;
}

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

// Philox4x32-10 (Salmon et al., SC'11), as Random123 defines it.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
  constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  constexpr uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += W0;
      k.y += W1;
    }
    const uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    const uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// Keep bytes for one warp's 8 rows x 32 columns [c0, c0 + 32) (c0 a
// multiple of 32): lanes 0..15 each draw one Philox block (row r0 + lane/2,
// column block c0/16 + lane%2) into words[8][8]; afterwards lane j reads
// the byte of (row r0 + i, column c0 + j) with keep_byte(words, i, j).
// The caller synchronises the warp before the words are read and before
// they are written again.
__device__ __forceinline__ void draw_keep_words(uint32_t (*words)[8], uint32_t seed,
                                                uint32_t bh, int r0, int c0, int lane) {
  if (lane < 16) {
    const uint4 w = philox4x32_10(
        make_uint4(static_cast<uint32_t>(c0 / 16 + (lane & 1)),
                   static_cast<uint32_t>(r0 + (lane >> 1)), 0u, 0u),
        make_uint2(seed, bh));
    uint32_t* dst = &words[lane >> 1][(lane & 1) * 4];
    dst[0] = w.x;
    dst[1] = w.y;
    dst[2] = w.z;
    dst[3] = w.w;
  }
}

__device__ __forceinline__ int keep_byte(uint32_t (*words)[8], int i, int lane) {
  return (words[i][lane >> 2] >> (8 * (lane & 3))) & 0xff;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  // above 48 KB dynamic shared memory must be opted into
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace whk
