// Dropout keep/scale matrices of the whole-head attention kernels, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel neko_tpu/ops/attention_kernel.py::
// dropout_keep_scale (#5): it writes, as fp32 [B, H, S, S], exactly the
// keep/scale values the forward and backward kernels apply in place
// (attention_common.cuh): drop_scale where the element's keep byte is
// >= drop_threshold, else 0.  Like the TPU kernel it exists so that the
// kernels can be held against a plain attention with the identical mask.
//
// One thread per 16 consecutive elements of a row (one Philox4x32-10 block);
// it is bound by the 4 bytes per element it writes (1.6 GB at B=16, H=24,
// S=1024), not by the generator.
//
// C interface (loaded with ctypes): reads o (the fp32 output view), seed, B,
// H, S, drop_threshold, drop_scale; returns the cudaError_t of the launch.

#include "attention_common.cuh"

namespace {

__global__ void dropout_keep_scale_kernel(const AttnArgs a) {
  const int n16 = (a.S + 15) / 16;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(a.B) * a.H * a.S * n16) return;
  const int c16 = static_cast<int>(idx % n16);
  const int r = static_cast<int>((idx / n16) % a.S);
  const int bh = static_cast<int>(idx / (static_cast<long long>(n16) * a.S));
  const uint4 w = whk::philox4x32_10(
      make_uint4(static_cast<uint32_t>(c16), static_cast<uint32_t>(r), 0u, 0u),
      make_uint2(static_cast<uint32_t>(a.seed[0]), static_cast<uint32_t>(bh)));
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
  float* out = whk::head_ptr<float>(a.o, bh / a.H, bh % a.H) + r * a.o.ss;
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const int c = c16 * 16 + e;
    if (c >= a.S) break;
    const int byte = (words[e >> 2] >> (8 * (e & 3))) & 0xff;
    out[c] = byte >= a.drop_threshold ? a.drop_scale : 0.f;
  }
}

}  // namespace

extern "C" int dropout_keep_scale(const AttnArgs* a, void* stream) {
  if (a->B <= 0 || a->H <= 0 || a->S <= 0) return cudaSuccess;
  if (a->seed == nullptr || a->o.ptr == nullptr) return cudaErrorInvalidValue;
  const long long n = static_cast<long long>(a->B) * a->H * a->S * ((a->S + 15) / 16);
  constexpr int kThreads = 256;
  dropout_keep_scale_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(*a);
  return cudaGetLastError();
}
