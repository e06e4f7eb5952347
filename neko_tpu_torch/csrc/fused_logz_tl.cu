// Fused loss head forward: logits tile product, online logsumexp and target
// logit, without the [N, V] logits, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel neko_tpu/ops/loss_kernel.py::_nll_fwd_kernel
// (#15, via fused_logz_tl): for every row of x [N, D] and the head weight
// W [V, D] (the torch layout; the TPU kernel takes its transpose [D, V]),
// logz = log(sum_c exp(x . W[c])) over the columns c < valid_vocab, and the
// logit of the row's target column.  The padded columns (c >= valid_vocab)
// get the finite fill -1e30 and drop out of the sum; the target is taken by
// a masked compare (col == t), as the TPU kernel takes it.
//
// What bounds it on the H100: the product, 2 N D V operations (3.30e11 for a
// 4096-row chunk of the flagship's 768 x 52,480 head, 0.334 ms at the 989
// TFLOP/s bf16 tensor-core peak), against ~90 MB of operands; it is compute
// bound.  The tile product runs on the tensor cores through nvcuda::wmma (bf16
// in, fp32 accumulate, 16x16x16 fragments): a block owns 128 rows and walks its
// share of the vocabulary in 128-column tiles, 8 warps each computing a 64 x 32
// part of the [128, 128] tile in 32-deep steps of D, with the next step's x
// and W slices loaded into registers while the current ones multiply from
// shared memory.  The finished tile goes through shared memory (the same bytes
// as the operand buffers) to the row reduction: two threads per row fold its
// 128 logits into a running (max, sum of exp, target logit).  Rows are few
// (4,096) and the vocabulary long, so the vocabulary is also split over
// blocks (grid.y), and a second kernel merges each row's partial (max, sum,
// target) triples; nothing [N, V]-sized is written.  Not done yet: wgmma,
// TMA and a deeper pipeline.
//
// C interface (loaded with ctypes): returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

struct LossArgs {
  const __nv_bfloat16* x;  // [N, D], row stride sx (elements)
  const __nv_bfloat16* w;  // [V, D], row stride sw
  const int* t;            // [N] target columns
  float* part;             // fp32 [3, n_split, N] scratch: max, sum, target logit
  float* logz;             // fp32 [N]
  float* tl;               // fp32 [N]
  long long sx, sw;
  int N, D, V, valid_vocab, n_split;  // 0 < valid_vocab <= V
};

namespace {

namespace wmma = nvcuda::wmma;

constexpr float kNeg = -1e30f;
constexpr int BM = 128, BN = 128, BK = 32, kThreads = 256;
constexpr int LDS = BK + 8;     // operand row pitch in shared memory (bf16)
constexpr int LDC = BN + 4;     // logits tile row pitch (fp32)
constexpr int kOperandBytes = 2 * 2 * BM * LDS * 2;  // x and W slices, double-buffered
constexpr int kTileBytes = BM * LDC * 4;
constexpr int kSmemBytes = kOperandBytes > kTileBytes ? kOperandBytes : kTileBytes;
static_assert(BM == BN, "one loader serves the x and W slices");

// one 32-deep slice of 128 rows: 128 * 64 bytes, two 16-byte loads a thread
__device__ __forceinline__ void load_slice(const __nv_bfloat16* src, long long stride, int row0,
                                           int rows, int k0, uint4 (&r)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = threadIdx.x + i * kThreads, row = idx >> 2, seg = idx & 3;
    r[i] = row0 + row < rows
               ? __ldg(reinterpret_cast<const uint4*>(src + (row0 + row) * stride + k0 + seg * 8))
               : make_uint4(0u, 0u, 0u, 0u);
  }
}

__device__ __forceinline__ void store_slice(__nv_bfloat16* dst, const uint4 (&r)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = threadIdx.x + i * kThreads, row = idx >> 2, seg = idx & 3;
    *reinterpret_cast<uint4*>(dst + row * LDS + seg * 8) = r[i];
  }
}

__global__ void __launch_bounds__(kThreads) fused_logz_tl_kernel(const LossArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][BM][LDS]
  __nv_bfloat16* ws = xs + 2 * BM * LDS;                         // [2][BN][LDS]
  float* cs = reinterpret_cast<float*>(smem);                    // [BM][LDC], after the product

  const int row0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, wr = warp >> 2, wc = warp & 3;  // 2 x 4 warps
  const int n_tiles = (a.V + BN - 1) / BN;
  const int per = (n_tiles + a.n_split - 1) / a.n_split;
  const int tile_lo = blockIdx.y * per, tile_hi = min(n_tiles, tile_lo + per);
  const int nk = a.D / BK;

  // the row this thread reduces (two threads a row, every other column each)
  const int my_row = threadIdx.x >> 1, half = threadIdx.x & 1;
  const int grow = row0 + my_row;
  const int target = grow < a.N ? a.t[grow] : -1;
  float m_run = kNeg, s_run = 0.f, tl_run = 0.f;

  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    const int col0 = tile * BN;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    uint4 rx[2], rw[2];
    load_slice(a.x, a.sx, row0, a.N, 0, rx);
    load_slice(a.w, a.sw, col0, a.V, 0, rw);
    store_slice(xs, rx);
    store_slice(ws, rw);
    __syncthreads();
    for (int kc = 0; kc < nk; ++kc) {
      const int buf = kc & 1;
      if (kc + 1 < nk) {  // the next slice is in flight while this one multiplies
        load_slice(a.x, a.sx, row0, a.N, (kc + 1) * BK, rx);
        load_slice(a.w, a.sw, col0, a.V, (kc + 1) * BK, rw);
      }
      const __nv_bfloat16* xb = xs + buf * BM * LDS;
      const __nv_bfloat16* wb = ws + buf * BN * LDS;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[4];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb[2];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          wmma::load_matrix_sync(fa[i], xb + (wr * 64 + i * 16) * LDS + kk, LDS);
#pragma unroll
        for (int j = 0; j < 2; ++j)  // B[k][n] = W[n][k]: W's rows as columns
          wmma::load_matrix_sync(fb[j], wb + (wc * 32 + j * 16) * LDS + kk, LDS);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      if (kc + 1 < nk) {
        store_slice(xs + (buf ^ 1) * BM * LDS, rx);
        store_slice(ws + (buf ^ 1) * BN * LDS, rw);
      }
      __syncthreads();
    }
    // the [BM, BN] logits tile, over the operand buffers (every warp is past them)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(cs + (wr * 64 + i * 16) * LDC + wc * 32 + j * 16, acc[i][j],
                                LDC, wmma::mem_row_major);
    __syncthreads();

    // this thread's columns: half, half + 2, ... (2-way shared-memory bank
    // conflicts at most, where 64 neighbouring columns would make them 4-way)
    const float* crow = cs + my_row * LDC + half;
    const int c0 = col0 + half;
    float tmax = kNeg, hit = 0.f;
    for (int c = 0; c < BN; c += 2) {
      const int col = c0 + c;
      const float z = col < a.valid_vocab ? crow[c] : kNeg;
      tmax = fmaxf(tmax, z);
      if (col == target) hit = z;
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m_run, tmax);
    float s = 0.f;
    for (int c = 0; c < BN; c += 2)
      if (c0 + c < a.valid_vocab) s += __expf(crow[c] - m_new);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    hit += __shfl_xor_sync(0xffffffffu, hit, 1);
    s_run = s_run * __expf(m_run - m_new) + s;
    tl_run += hit;
    m_run = m_new;
    __syncthreads();  // the tile is read before the next slices overwrite it
  }
  if (half == 0 && grow < a.N) {
    const long long i = static_cast<long long>(blockIdx.y) * a.N + grow;
    const long long plane = static_cast<long long>(a.n_split) * a.N;
    a.part[i] = m_run;
    a.part[plane + i] = s_run;
    a.part[2 * plane + i] = tl_run;
  }
}

// one thread a row: merge the n_split partial (max, sum, target logit)
__global__ void merge_kernel(const LossArgs a) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= a.N) return;
  const long long plane = static_cast<long long>(a.n_split) * a.N;
  float mx = kNeg;
  for (int s = 0; s < a.n_split; ++s) mx = fmaxf(mx, a.part[s * a.N + row]);
  float sum = 0.f, tl = 0.f;
  for (int s = 0; s < a.n_split; ++s) {
    const long long i = static_cast<long long>(s) * a.N + row;
    sum += a.part[plane + i] * expf(a.part[i] - mx);
    tl += a.part[2 * plane + i];
  }
  a.logz[row] = mx + logf(sum);
  a.tl[row] = tl;
}

}  // namespace

extern "C" int fused_logz_tl(const LossArgs* a, void* stream) {
  if (a->N <= 0) return cudaSuccess;
  if (a->D <= 0 || a->D % BK != 0 || a->V <= 0 || a->n_split <= 0 || a->valid_vocab <= 0 ||
      a->valid_vocab > a->V || a->sx % 8 != 0 || a->sw % 8 != 0 ||
      a->x == nullptr || a->w == nullptr || a->t == nullptr || a->part == nullptr)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_logz_tl_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((a->N + BM - 1) / BM, a->n_split);
  fused_logz_tl_kernel<<<grid, kThreads, kSmemBytes, s>>>(*a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_kernel<<<(a->N + 255) / 256, 256, 0, s>>>(*a);
  return cudaGetLastError();
}
