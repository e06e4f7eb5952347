// The tensor-core primitives that the bf16 attention tiles share: the
// forward (attention_fwd.cuh, #1, #3, #6, #11) and the backward
// (attention_bwd.cuh, #2, #4, #7-#9, #12, #13).  Every product is
// mma.sync.m16n8k16 with bf16 operands and fp32 accumulators, its operands
// read from shared memory by ldmatrix; tiles arrive in shared memory by
// cp.async, bf16 rows padded by 16 bytes so that the eight rows an ldmatrix
// reads fall in distinct banks.

#pragma once

#include <stdint.h>

#include "attention_common.cuh"

namespace {

namespace tc {


using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kKeys = 64;   // keys of a kv block, and of a key tile of the dq block
constexpr int kRows = 64;   // q rows of a dq block (16 a warp)
constexpr int kPad = 8;     // bf16 padding of a shared-memory row (16 bytes)
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (4) bytes global -> shared without the registers; !pred writes zeros
// and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix
// i, and lane l receives (row l / 4, columns 2 (l % 4), +1) of each
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// the same, transposed: lane l receives (rows 2 (l % 4), +1; column l / 4)
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a b, one m16n8k16 tile: bf16 operands, fp32 accumulators.  With
// g = lane / 4, t = lane % 4: a = {(g, 2t..2t+1), (g + 8, 2t..), (g, 2t + 8..),
// (g + 8, 2t + 8..)}, b = {(2t..2t+1, g), (2t + 8.., g)}, d = {(g, 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)} (row, column).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 in one register, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// Operand addresses of lane l in a tile stored row-major with row stride P,
// for the 16 x 16 block at (row0, col0):
// A operand (rows = M, columns = K):
__device__ __forceinline__ const bf16* a_addr(const bf16* s, int P, int row0, int col0, int l) {
  return s + (row0 + (l & 15)) * P + col0 + (l >> 4) * 8;
}
// B operands of two n8 tiles from a tile stored [N][K] (b^T row-major):
// registers {0, 1} -> columns n0..n0+7, {2, 3} -> n0+8..n0+15
__device__ __forceinline__ const bf16* bt_addr(const bf16* s, int P, int n0, int k0, int l) {
  return s + (n0 + (l & 7) + ((l >> 4) << 3)) * P + k0 + ((l >> 3) & 1) * 8;
}
// B operands of two n8 tiles from a tile stored [K][N] (ldsm_t)
__device__ __forceinline__ const bf16* b_addr(const bf16* s, int P, int k0, int n0, int l) {
  return s + (k0 + (l & 7) + ((l >> 3) & 1) * 8) * P + n0 + (l >> 4) * 8;
}
// A operand from a tile stored [K][M] (a^T row-major; ldsm_t)
__device__ __forceinline__ const bf16* at_addr(const bf16* s, int P, int k0, int m0, int l) {
  return s + (k0 + (l & 7) + (l >> 4) * 8) * P + m0 + ((l >> 3) & 1) * 8;
}

// rows [first, first + ROWS) of a [S, D] head with row stride ss into a
// [ROWS][D + kPad] tile; rows outside [0, S) are zeros
template <int ROWS, int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long long ss, int first,
                                          int S) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  constexpr int kIters = (ROWS * kChunks + kThreads - 1) / kThreads;
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = threadIdx.x + it * kThreads;
    if (ROWS * kChunks % kThreads == 0 || i < ROWS * kChunks) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const int gr = first + r;
      const bool ok = gr >= 0 && gr < S;
      cp_async16(dst + r * (D + kPad) + c, ok ? src + gr * ss + c : src, ok);
    }
  }
}

// fp32 [rows] of a row-stat array from row `first`; rows >= S are 0
template <int ROWS>
__device__ __forceinline__ void load_stat(float* dst, const float* src, int first, int S) {
  for (int i = threadIdx.x; i < ROWS; i += kThreads) {
    const bool ok = first + i < S;
    cp_async4(dst + i, ok ? src + first + i : src, ok);
  }
}

__device__ __forceinline__ int byte_of(uint32_t w, int i) { return (w >> (8 * i)) & 0xff; }

// The bf16 tiles copy their inputs 16 bytes at a time and store their
// outputs two values at a time: every input view needs a 16-byte aligned
// pointer and strides that are multiples of 8 elements, every output view
// an 8-byte aligned pointer and even strides.
inline bool aligned(const View& v, int bytes, int elems) {
  return v.ptr == nullptr || (reinterpret_cast<uintptr_t>(v.ptr) % bytes == 0 &&
                              v.sb % elems == 0 && v.sh % elems == 0 && v.ss % elems == 0);
}

}  // namespace tc

}  // namespace
