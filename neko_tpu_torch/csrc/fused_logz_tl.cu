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
// bound, so the design keeps the tensor cores fed and hides the rest:
//
// * Operands by TMA.  Thread 0 copies 64-deep k-slices of x [128 rows] and
//   W [128 rows] with cp.async.bulk.tensor into a ring of kStages = 7
//   shared-memory stages (full/empty mbarrier pairs), kStages - 2 - kLag = 3
//   slices ahead of the products.  Both slices are K-major, as wgmma takes
//   both operands, with the 128-byte swizzle that the wgmma shared memory
//   descriptors name too.  TMA fills out-of-bounds boxes with zeros, so a
//   ragged N, V or D needs no code: D only has to give rows a 16-byte pitch
//   (D % 8 == 0).  No producer warp of its own: a block of 256 threads lets
//   ptxas give a thread 255 registers, which the two accumulator sets below
//   need; a ninth warp would share a register file quarter with two others
//   (168 a thread), and ptxas allocated 168 for the consumers of a producer
//   warpgroup even with setmaxnreg raising them to 240 (and spilled).
// * Products on wgmma.mma_async m64n128k16 (bf16 in, fp32 accumulate): each
//   consumer warpgroup owns 64 rows of the block's 128 and computes their
//   [64, 128] logits tile in registers.  It holds two accumulator sets and
//   folds tile j into its running statistics while tile j + 1's products
//   run: the fold starts once the first two k-slices of tile j + 1 are
//   issued, and at most two k-slices are in flight (wgmma.wait_group 2).
// * The epilogue on the accumulator registers, never through shared memory.
//   A thread holds rows 16 w + lane/4 (and + 8) at columns
//   8 j + 2 (lane % 4) + {0, 1}; it keeps a running (max, sum of exp, target
//   logit) per row over its own columns, and the four lanes of a row merge
//   theirs with two shuffles when a work item ends.  A row that has seen only
//   masked columns takes 0 as its max for the exp, so fills give exp -> 0
//   and never NaN.
// * Work order, so that W (80.6 MB, over the 50 MB L2) streams from device
//   memory about once: a persistent grid (one block per SM) walks work items
//   (row block of 128, vocabulary range of split_tiles 128-column tiles)
//   vocab-major, block b taking items b, b + grid, ...  The blocks in flight
//   share each W range in L2 (all row blocks of one range are neighbours in
//   the order), and x (6.3 MB) stays in L2.  No cluster multicast: the L2
//   already serves each W tile to every row block.  Each row gets one
//   partial (max, sum, target logit) per vocabulary range, n_split of them
//   (52 at V = 52,480 in 1,024-column ranges), merged by a second kernel.
//
// C interface (loaded with ctypes): returns the cudaError_t of the launch.
// The tensor maps are encoded on every call (a cache keyed by pointer would
// outlive torch's reuse of the memory), through the driver entry point
// cuTensorMapEncodeTiled that the runtime hands out.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

struct LossArgs {
  const __nv_bfloat16* x;  // [N, D], row stride sx (elements)
  const __nv_bfloat16* w;  // [V, D], row stride sw
  const int* t;            // [N] target columns
  float* part;             // fp32 [3, n_split, N] scratch: max, sum, target logit
  float* logz;             // fp32 [N]
  float* tl;               // fp32 [N]
  long long sx, sw;
  int N, D, V, valid_vocab;  // 0 < valid_vocab <= V
  int n_split;               // vocabulary ranges (the caller's count: it sizes `part`)
  int split_tiles;           // 128-column tiles a range: set by fused_logz_tl from n_split
};

namespace {

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int BM = 128, BN = 128, BK = 64;  // BK: one 128-byte swizzle row of bf16
constexpr int kStages = 7;
constexpr int kLag = 2;                      // k-slices warpgroup 1 may trail warpgroup 0
constexpr int kThreads = 256;                // 2 warpgroups
constexpr int kSliceBytes = BM * BK * 2;     // one operand's k-slice (BM == BN)
constexpr int kStageBytes = 2 * kSliceBytes;
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;  // + alignment
static_assert(BM == BN, "x and W slices share one box shape");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// spin until the phase of parity `parity` has completed (a fresh barrier
// counts as having completed the phase of parity 1); a wait that outlasts
// seconds is a broken pipeline, and traps rather than hang the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 26)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// box (c0 = column in D, c1 = row) of a 2-d bf16 tensor map into shared memory
__device__ __forceinline__ void tma_load(const CUtensorMap* map, uint32_t dst, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile of 128-byte rows in the
// 128-byte swizzle (the layout TMA wrote): start address >> 4, leading byte
// offset 16 (unused when swizzled), stride byte offset 1024 between groups of
// 8 rows, swizzle mode 1 (128 B).  The tile starts on a 1024-byte boundary,
// so the base offset is 0; a k16 step within the 64-wide slice adds 32 bytes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads of d across a wgmma wait
__device__ __forceinline__ void fence_operand(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// one 128-column logits tile of a work item
struct Tile {
  int rb, col0, split;
  bool first, last;  // of its work item
};

// a consumer thread's running (max, sum of exp, target logit) of its two
// rows over the columns it holds, since its work item began
struct Running {
  float m[2], s[2], tl[2];
  int tgt[2];
};

// The block's tiles in order: work items blockIdx.x, + gridDim.x, ...; item
// i is vocabulary range i / n_rb of row block i % n_rb.
struct TileWalk {
  int n_rb, n_tiles, n_items, item, tile, tile_end, rb, split;

  __device__ void begin_item(int split_tiles) {
    split = item / n_rb;
    rb = item - split * n_rb;
    tile = split * split_tiles;
    tile_end = min(n_tiles, tile + split_tiles);
  }
  __device__ TileWalk(const LossArgs& a) {
    n_rb = (a.N + BM - 1) / BM;
    n_tiles = (a.V + BN - 1) / BN;
    n_items = n_rb * a.n_split;
    item = blockIdx.x;
    if (item < n_items) begin_item(a.split_tiles);
  }
  __device__ bool done() const { return item >= n_items; }
  __device__ Tile current(int split_tiles) const {
    return Tile{rb, tile * BN, split, tile == split * split_tiles, tile + 1 == tile_end};
  }
  __device__ void next(int split_tiles) {
    if (++tile < tile_end) return;
    item += gridDim.x;
    if (item < n_items) begin_item(split_tiles);
  }
};

// Fold a finished [64, 128] tile (this warpgroup's rows) into `r`; at the end
// of its work item merge the row's four lanes and write the partial.
__device__ __forceinline__ void fold(float (&d)[64], const Tile& tile, Running& r,
                                     const LossArgs& a, int row_base, int lane) {
  if (tile.first) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = tile.rb * BM + row_base + 8 * rr;
      r.m[rr] = kNeg;
      r.s[rr] = 0.f;
      r.tl[rr] = 0.f;
      r.tgt[rr] = row < a.N ? __ldg(a.t + row) : -1;
    }
  }
  // a tile past valid_vocab reads its padded columns as the fill (never
  // written back: an in-flight wgmma's accumulators take no other writes)
  const int c_lane = tile.col0 + 2 * (lane & 3);
  const int ragged = tile.col0 + BN > a.valid_vocab ? a.valid_vocab - c_lane : 1 << 30;
#define LOGIT(i) \
  ((8 * ((i) >> 1) + ((i) & 1)) >= ragged ? kNeg : d[4 * ((i) >> 1) + 2 * rr + ((i) & 1)])
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float mx = kNeg;
#pragma unroll
    for (int i = 0; i < 32; ++i) mx = fmaxf(mx, LOGIT(i));
    const float m_new = fmaxf(r.m[rr], mx);
    const float ref = (m_new == kNeg ? 0.f : m_new) * kLog2e;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) sum += ex2(fmaf(LOGIT(i), kLog2e, -ref));
    r.s[rr] = r.s[rr] * ex2(fmaf(r.m[rr], kLog2e, -ref)) + sum;
    r.m[rr] = m_new;
    const int hit = r.tgt[rr] - c_lane;  // the target's offset from this lane's first column
    if (static_cast<unsigned>(r.tgt[rr] - tile.col0) < static_cast<unsigned>(BN)) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (8 * (i >> 1) + (i & 1) == hit) r.tl[rr] += LOGIT(i);
    }
  }
#undef LOGIT
  if (!tile.last) return;
  const long long plane = static_cast<long long>(a.n_split) * a.N;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float m = r.m[rr];
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    float s = r.s[rr] * ex2((r.m[rr] - m) * kLog2e);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    float t = r.tl[rr];
    t += __shfl_xor_sync(0xffffffffu, t, 1);
    t += __shfl_xor_sync(0xffffffffu, t, 2);
    const int row = tile.rb * BM + row_base + 8 * rr;
    if ((lane & 3) == 0 && row < a.N) {
      const long long i = static_cast<long long>(tile.split) * a.N + row;
      a.part[i] = m;
      a.part[plane + i] = s;
      a.part[2 * plane + i] = t;
    }
  }
}

// The shared-memory ring: kStages stages of an x and a W k-slice, and a
// full and an empty mbarrier per stage.
struct Ring {
  uint32_t stages, full, empty;
  __device__ uint32_t stage(int s) const { return stages + s * kStageBytes; }
  __device__ uint32_t full_bar(int s) const { return full + 8 * s; }
  __device__ uint32_t empty_bar(int s) const { return empty + 8 * s; }
};

// Thread 0's loads: the next k-slice of the block's tile walk into its
// stage, once both warpgroups have released the slice kStages before it.
struct Producer {
  TileWalk walk;
  int kc, stage;
  uint32_t phase;

  __device__ explicit Producer(const LossArgs& a) : walk(a), kc(0), stage(0), phase(0u) {}
  __device__ void load_next(const LossArgs& a, const Ring& ring, int nk, const CUtensorMap* xmap,
                            const CUtensorMap* wmap) {
    if (walk.done()) return;
    const Tile tile = walk.current(a.split_tiles);
    mbar_wait(ring.empty_bar(stage), phase ^ 1u);
    mbar_expect_tx(ring.full_bar(stage), kStageBytes);
    tma_load(xmap, ring.stage(stage), ring.full_bar(stage), kc * BK, tile.rb * BM);
    tma_load(wmap, ring.stage(stage) + kSliceBytes, ring.full_bar(stage), kc * BK, tile.col0);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1u;
    }
    if (++kc == nk) {
      kc = 0;
      walk.next(a.split_tiles);
    }
  }
};

// A consumer's position in the ring: the stage and phase of its next k-slice
// and the count of k-slices it has issued.
struct Cursor {
  int stage;
  uint32_t phase;
  long long issued;
};

// Issue one tile's products into `cur` (k-slice by k-slice as they arrive),
// and fold the previous tile from `prev` once it is complete, while the
// products of `cur` run.  After k-slice g, a warp releases the stage of
// slice g - 2 (its wgmma is done), and thread 0 loads slice
// g + kStages - 2 - kLag into the stage of slice g - 2 - kLag: so warpgroup 1
// may lag warpgroup 0 by kLag slices before thread 0 waits for it.
__device__ __forceinline__ void mma_tile(float (&cur)[64], float (&prev)[64], bool have_prev,
                                         const Tile& prev_tile, Running& r, Cursor& c,
                                         Producer& producer, const Ring& ring,
                                         const LossArgs& a, const CUtensorMap* xmap,
                                         const CUtensorMap* wmap, int nk, int wg, int row_base,
                                         int lane) {
  const int fold_at = nk > 1 ? 1 : 0;
  for (int kc = 0; kc < nk; ++kc) {
    mbar_wait(ring.full_bar(c.stage), c.phase);
    const uint64_t da = smem_desc(ring.stage(c.stage) + wg * 64 * 128);  // our 64 rows of x
    const uint64_t db = smem_desc(ring.stage(c.stage) + kSliceBytes);    // 128 rows of W
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < BK / 16; ++k) wgmma_m64n128k16(cur, da + 2 * k, db + 2 * k, kc | k);
    wgmma_commit();
    wgmma_wait<2>();  // the k-slice before last is done: release its stage
    if (c.issued >= 2 && lane == 0) mbar_arrive(ring.empty_bar((c.stage + kStages - 2) % kStages));
    if (threadIdx.x == 0 && c.issued >= 2 + kLag) producer.load_next(a, ring, nk, xmap, wmap);
    __syncwarp();
    ++c.issued;
    if (++c.stage == kStages) {
      c.stage = 0;
      c.phase ^= 1u;
    }
    if (have_prev && kc == fold_at) {
      if (nk == 1) wgmma_wait<1>();  // only this tile's one group may run on
      fence_operand(prev);
      fold(prev, prev_tile, r, a, row_base, lane);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    fused_logz_tl_kernel(const LossArgs a, const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap wmap) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t stages = (smem_u32(smem) + 1023u) & ~1023u;  // swizzled tiles: 1024-aligned
  const uint32_t bars = stages + kStages * kStageBytes;
  const Ring ring{stages, bars, bars + 8 * kStages};
  const int nk = (a.D + BK - 1) / BK;
  const int wg = threadIdx.x / 128, lane = threadIdx.x & 31;
  Producer producer(a);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(ring.full_bar(s), 1);   // thread 0's arrive, with the bytes
      mbar_init(ring.empty_bar(s), 8);  // one arrive per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int s = 0; s < kStages; ++s) producer.load_next(a, ring, nk, &xmap, &wmap);
  }
  __syncthreads();

  // warpgroup wg owns rows 64 wg .. 64 wg + 63 of each block
  const int row_base = 64 * wg + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  float acc0[64], acc1[64];
  Running r;
  Cursor c{0, 0u, 0};
  Tile prev{0, 0, 0, false, false};
  long long n = 0;  // tiles issued: tile n goes to acc0 when n is even
  for (TileWalk walk(a); !walk.done(); walk.next(a.split_tiles), ++n) {
    const Tile tile = walk.current(a.split_tiles);
    if (n & 1)
      mma_tile(acc1, acc0, true, prev, r, c, producer, ring, a, &xmap, &wmap, nk, wg, row_base,
               lane);
    else
      mma_tile(acc0, acc1, n > 0, prev, r, c, producer, ring, a, &xmap, &wmap, nk, wg,
               row_base, lane);
    prev = tile;
  }
  wgmma_wait<0>();
  if (n & 1) {
    fence_operand(acc0);
    fold(acc0, prev, r, a, row_base, lane);
  } else if (n > 0) {
    fence_operand(acc1);
    fold(acc1, prev, r, a, row_base, lane);
  }
}

// one thread a row: merge the n_split partial (max, sum, target logit)
__global__ void fused_logz_tl_merge(const LossArgs a) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= a.N) return;
  const long long plane = static_cast<long long>(a.n_split) * a.N;
  float mx = kNeg;
  for (int s = 0; s < a.n_split; ++s) mx = fmaxf(mx, a.part[static_cast<long long>(s) * a.N + row]);
  float sum = 0.f, tl = 0.f;
  for (int s = 0; s < a.n_split; ++s) {
    const long long i = static_cast<long long>(s) * a.N + row;
    sum += a.part[plane + i] * expf(a.part[i] - mx);
    tl += a.part[2 * plane + i];
  }
  a.logz[row] = mx + logf(sum);
  a.tl[row] = tl;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &q);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a [rows, D] bf16 matrix of row stride `stride` elements, in [128, 64] boxes
// with the 128-byte swizzle; boxes past the edge read zeros
bool encode(CUtensorMap* map, const void* ptr, int rows, int D, long long stride, bool stream) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(stride) * 2};
  const cuuint32_t box[2] = {BK, BM};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            stream ? CU_TENSOR_MAP_L2_PROMOTION_L2_256B : CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" int fused_logz_tl(const LossArgs* args, void* stream) {
  if (args->N <= 0) return cudaSuccess;
  LossArgs a = *args;
  const int tiles = (a.V + BN - 1) / BN;
  a.split_tiles = a.n_split > 0 ? (tiles + a.n_split - 1) / a.n_split : 0;
  if (a.D <= 0 || a.D % 8 != 0 || a.V <= 0 || a.valid_vocab <= 0 ||
      a.valid_vocab > a.V || a.n_split <= 0 ||
      (a.n_split - 1) * a.split_tiles >= tiles ||  // every range holds a tile
      a.sx % 8 != 0 || a.sw % 8 != 0 || reinterpret_cast<uintptr_t>(a.x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(a.w) % 16 != 0 || a.t == nullptr || a.part == nullptr)
    return cudaErrorInvalidValue;
  CUtensorMap xmap, wmap;
  if (!encode(&xmap, a.x, a.N, a.D, a.sx, false) ||
      !encode(&wmap, a.w, a.V, a.D, a.sw, true))
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fused_logz_tl_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long items = static_cast<long long>((a.N + BM - 1) / BM) * a.n_split;
  const int grid = static_cast<int>(items < sms ? items : sms);
  fused_logz_tl_kernel<<<grid, kThreads, kSmemBytes, s>>>(a, xmap, wmap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fused_logz_tl_merge<<<(a.N + 255) / 256, 256, 0, s>>>(a);
  return cudaGetLastError();
}
