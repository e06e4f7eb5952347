// Dropout keep/scale matrices of the attention kernels, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU Pallas kernels neko_tpu/ops/attention_kernel.py::
// dropout_keep_scale (#5) and neko_tpu/ops/blocked_attention.py::
// dropout_keep_scale (#10): it writes, as fp32 [B, H, S, S], exactly the
// keep/scale values the forward and backward kernels apply in place
// (attention_common.cuh): drop_scale where the element's keep byte is
// >= drop_threshold, else 0.  Like the TPU kernels it exists so that the kernels can be held against a plain
// attention with the identical mask.  The bits come from whk::philox4x32_10,
// the generator the attention kernels inline.
//
// What bounds it on the H100: the 4 bytes it writes per element (1.6 GB at
// B=16, H=24, S=1024: 0.48 ms at 3.35 TB/s); a Philox block costs ~100
// integer instructions for 64 bytes of output, well under that.  So every
// warp store instruction writes 512 contiguous bytes: a warp owns 4 rows x
// 128 columns; each lane draws one Philox block (row lane / 8, 16-column
// block lane % 8) into a shared-memory stage, and for each row lane l then
// stores the float4 of columns 4l .. 4l + 3 from word l % 4 of block l / 4
// (neighbouring lanes on neighbouring addresses, streaming stores).  Where S
// is no multiple of 4 a row's float4s would not be 16-byte aligned, so each
// lane stores four scalars instead, columns l, l + 32, l + 64, l + 96: still
// 128 contiguous bytes a store instruction.  Rows and columns past the edge
// are skipped (S = 1 and S = 17 work).
//
// C interface (loaded with ctypes): returns the cudaError_t of the launch.

#include "attention_common.cuh"

struct MaskArgs {
  float* out;         // fp32 [B, H, S, S], contiguous
  const int* seed;    // int32 [1] on the device
  int B, H, S, drop_threshold;
  float drop_scale;
};

namespace {

constexpr int kWarps = 8, kRows = 4, kCols = 128;  // a warp's tile: 4 rows x 128 columns

__device__ __forceinline__ float keep(uint32_t word, int byte, const MaskArgs& a) {
  return static_cast<int>((word >> (8 * byte)) & 0xffu) >= a.drop_threshold ? a.drop_scale : 0.f;
}

__global__ void __launch_bounds__(32 * kWarps) dropout_keep_scale_kernel(const MaskArgs a) {
  __shared__ uint4 stage[kWarps][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col_tiles = (a.S + kCols - 1) / kCols, row_tiles = (a.S + kRows - 1) / kRows;
  const long long t = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (t >= static_cast<long long>(a.B) * a.H * row_tiles * col_tiles) return;
  const int ct = static_cast<int>(t % col_tiles);
  const int rt = static_cast<int>((t / col_tiles) % row_tiles);
  const int bh = static_cast<int>(t / (static_cast<long long>(col_tiles) * row_tiles));
  const int r0 = rt * kRows, c0 = ct * kCols;

  const int my_row = r0 + (lane >> 3), my_block = c0 / 16 + (lane & 7);
  if (my_row < a.S && my_block * 16 < a.S)
    stage[warp][lane] = whk::philox4x32_10(
        make_uint4(static_cast<uint32_t>(my_block), static_cast<uint32_t>(my_row), 0u, 0u),
        make_uint2(static_cast<uint32_t>(a.seed[0]), static_cast<uint32_t>(bh)));
  __syncwarp();
  const uint32_t* words = reinterpret_cast<const uint32_t*>(stage[warp]);
  float* out = a.out + static_cast<long long>(bh) * a.S * a.S;
  for (int i = 0; i < kRows && r0 + i < a.S; ++i) {
    float* row = out + static_cast<long long>(r0 + i) * a.S;
    if (a.S % 4 == 0) {
      const int c = c0 + 4 * lane;
      if (c < a.S) {
        const uint32_t w = words[(i * 8 + (lane >> 2)) * 4 + (lane & 3)];
        __stcs(reinterpret_cast<float4*>(row + c),
               make_float4(keep(w, 0, a), keep(w, 1, a), keep(w, 2, a), keep(w, 3, a)));
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int off = lane + 32 * e, c = c0 + off;  // block off / 16, byte off % 16
        if (c < a.S) {
          const uint32_t w = words[(i * 8 + (off >> 4)) * 4 + ((off & 15) >> 2)];
          __stcs(row + c, keep(w, off & 3, a));
        }
      }
    }
  }
}

}  // namespace

extern "C" int dropout_keep_scale(const MaskArgs* a, void* stream) {
  if (a->B <= 0 || a->H <= 0 || a->S <= 0) return cudaSuccess;
  if (a->seed == nullptr || a->out == nullptr || reinterpret_cast<uintptr_t>(a->out) % 16 != 0)
    return cudaErrorInvalidValue;
  const long long tiles = static_cast<long long>(a->B) * a->H * ((a->S + kRows - 1) / kRows) *
                          ((a->S + kCols - 1) / kCols);
  dropout_keep_scale_kernel<<<static_cast<unsigned>((tiles + kWarps - 1) / kWarps),
                              32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  return cudaGetLastError();
}
