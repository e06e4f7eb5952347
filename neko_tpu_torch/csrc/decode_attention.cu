// Decode-step cache attention, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel neko_tpu/ops/decode_attention.py::_kernel
// (#14, via decode_cache_attention): one query per (batch row, head) against
// the KV cache rows j with mask[b, j] set, start[b] <= j < end[b], with fp32
// scores, an fp32 softmax and the fp32 value sum; one output row in the
// query's dtype.  The caches are only read (the TPU kernel passes them
// through identity-aliased).  The window [start, end) is the range of work
// (the first to the last valid row); the mask skips the rows inside it that
// are not valid, as neko_tpu's decode step masks them (its bias over the
// whole cache mask), so a cache whose valid rows have holes attends to the
// valid ones alone.
//
// What bounds it on the H100: every valid key row is read once from K and
// once from V, and each byte meets ~1 FLOP (a dot product and an axpy per
// row of hd values), so HBM bandwidth: at B=8, H=24, S=1024, hd=32 bf16 that
// is 25.2 MB a layer, 7.5 us at 3.35 TB/s; at B=1 3.1 MB, 0.94 us, where the
// launch and two dependent round trips to device memory (start / end, then
// the rows) are most of the time.  The TPU kernel copies a head group's
// whole cache slice to VMEM and then computes.  A first design here ran one
// block per (b, h) that streamed the rows into registers; what held it back,
// and what this design does about it:
//
// * Too few blocks (24 at B=1 on 132 SMs, a block's 1 MB at one block's
//   rate at S=8192): each (b, h) window is split over a thread-block cluster
//   of n blocks (n <= 8, the portable size), n chosen by the host from B, H,
//   the capacity S and the SM count alone (ops/decode_attention.py
//   `split_count`: the least power of two that gives every SM a block, as
//   past that a split only adds blocks, barriers and a merge; the host never
//   reads start / end).  Each block derives its share of its own
//   row's window on the device (`share`, the formula of `split_bounds` in the
//   wrapper) and keeps a partial (m, l, acc[hd]).  Every block writes its
//   partial into its slot in rank 0's shared memory (distributed shared
//   memory) and arrives on the cluster barrier; rank 0 waits, merges the
//   slots with the (m, l) rescale and writes the row.  Only rank 0's shared
//   memory is read across blocks, so the others leave after they arrive; a
//   first arrive at the start, waited on before the slots are written, makes
//   sure rank 0 runs.  One launch, no scratch in device memory.  A block with
//   an empty share (a window shorter than n, or none) writes m = -1e30,
//   l = 0.  n = 1 writes its row itself: no barrier, no merge, and no
//   cluster attribute on the launch.
// * Bytes in flight a block (registers held 4 rows a lane): one producer
//   thread streams the share as row tiles of K and V (and, over an int8
//   cache, the matching slices of the fp32 row scales) by bulk copies
//   (cp.async.bulk, completion on an mbarrier) into a ring of kStages
//   shared-memory stages of 16 KB (+ scales), while eight consumer warps
//   work on the tile before.  Two stages measured faster than three or four
//   (smaller blocks, more of them resident on an SM).  A (b, h)'s rows are
//   one contiguous run (the wrapper checks it), so a tile is one copy an
//   operand.  Tiles start on a multiple of 4 rows, so a tile's scale slice
//   starts on 16 bytes (the wrapper checks the scale rows start on 16
//   bytes); K / V are copied for the share's rows only, the scales from the
//   tile's first row to the share's last rounded up to 4, and each stage's
//   barrier expects exactly the bytes copied.  Rows outside the share or
//   the mask are masked.
// * Scalar scale loads and int-to-float conversions (int8): the scales
//   arrive with their tile; a value is dequantized by a byte permute and a
//   subtraction (2^23 + 128 + x as an fp32's low byte), not by a conversion
//   at a quarter of their rate.
//
// Consumers: each lane reads 16 bytes of a key row and the same 16 bytes of
// its value row from shared memory (hd / (16 bytes) lanes cover a row, a
// warp 512 contiguous bytes: no bank conflicts); each lane group keeps its
// own online softmax (running max, sum, fp32 accumulator of its slice of
// hd), the groups merge by warp shuffles, the warps through shared memory,
// the blocks of a cluster through rank 0's.  The mask is read per row from
// device memory before the wait for the tile, and q beside start / end.
//
// The fill of a key outside the window or the mask is finite (-1e30, never
// -inf), and a row with no key (start >= end, or no mask bit set in the
// window) writes zeros, never NaN.  Only [start, end) is read, so a short
// window costs only its own rows.
//
// The int8 cache (ModelConfig.kv_cache_dtype='int8'; neko_tpu's
// `_quant_cache_attention`, an XLA path there, models/transformer.py:60-90):
// keys and values are int8 rows with one fp32 scale a row (ks, vs: [B, H, S]).
// The same kernel, instantiated on int8 rows: 16 bytes a lane are 16 int8
// values, dequantized in registers (never a dequantized copy of the cache),
// the score q.k_int8 * sm_scale * ks[j] and the value sum of p * vs[j] *
// v_int8[j] in fp32, p in fp32 where neko_tpu rounds p * vs to the
// activation dtype.  At B=8, H=24, S=1024, hd=32 it reads 12.6 MB of rows and
// 1.6 MB of scales a layer: 4.2 us at 3.35 TB/s.
//
// C interface (loaded with ctypes): returns the cudaError_t of the launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

struct View {
  void* ptr;
  long long sb, sh, ss;  // batch, head, row strides (elements); hd is contiguous
};

struct DecodeArgs {
  View q, k, v, o;  // q, o: [B, H, hd] (ss unused); k, v: [B, H, S, hd], ss == hd
  const int* start;
  const int* end;
  const uint8_t* mask;  // bool [B, S] valid cache rows, row stride mask_sb; null: all
  long long mask_sb;
  int B, H, S, D, dtype;  // dtype of q and o: 0 = float32, 1 = bfloat16
  float sm_scale;
  int int8_cache;  // 1: k, v are int8 rows with fp32 row scales ks, vs
  View ks, vs;     // [B, H, S] fp32 (ss unused: the rows are contiguous, on 16 bytes)
  int n_split;     // blocks (one cluster) a (b, h) window is split over, 1..kMaxSplit
};

namespace {

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 8;                     // consumer warps
constexpr int kThreads = (kWarps + 1) * 32;   // and one producer warp
constexpr int kStages = 2;                    // shared-memory ring
constexpr int kUnroll = 2;                    // rows a lane group takes from a tile
constexpr int kMaxSplit = 8;                  // the portable cluster size

// 16 bytes of a row as floats
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& r, float* x) {
    x[0] = __uint_as_float(r.x); x[1] = __uint_as_float(r.y);
    x[2] = __uint_as_float(r.z); x[3] = __uint_as_float(r.w);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& r, float* x) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a bf16 is the top half of an fp32
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <> struct Vec<int8_t> {
  static constexpr int N = 16;
  // x + 128 as the low byte of the fp32 2^23 + (x + 128), one byte permute
  // and one add a value (an int-to-float conversion runs at a quarter of the
  // rate of either)
  __device__ __forceinline__ static void unpack(const uint4& r, float* x) {
    const uint32_t w[4] = {r.x ^ 0x80808080u, r.y ^ 0x80808080u, r.z ^ 0x80808080u,
                           r.w ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        x[4 * i + k] = __uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7540u | k)) -
                       8388736.0f;  // 2^23 + 128
    }
  }
};

// N consecutive values of type T (q) as floats, from 16-byte loads
template <typename T, int N>
__device__ __forceinline__ void load_floats(const T* p, float* x) {
  constexpr int P = Vec<T>::N;
  static_assert(N % P == 0, "a lane's columns are whole 16-byte loads of q");
#pragma unroll
  for (int i = 0; i < N / P; ++i)
    Vec<T>::unpack(__ldg(reinterpret_cast<const uint4*>(p + i * P)), x + i * P);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// The geometry of a stage for cache rows of type C and width D.
template <typename C, int D> struct Tile {
  static constexpr int VEC = 16 / static_cast<int>(sizeof(C));  // a lane's columns
  static constexpr int LPK = D / VEC;                            // lanes that cover a row
  static constexpr int KPW = 32 / LPK;                           // rows a warp covers at once
  static constexpr int ROWS = kWarps * KPW * kUnroll;            // rows a stage holds
  static constexpr int ROW_BYTES = D * static_cast<int>(sizeof(C));
  static constexpr int KV_BYTES = ROWS * ROW_BYTES;               // 8 KB: one of K, V
  static constexpr int SCALE_BYTES = sizeof(C) == 1 ? ROWS * 4 : 0;
  static constexpr int STAGE_BYTES = 2 * KV_BYTES + 2 * SCALE_BYTES;
  static constexpr int SMEM = kStages * STAGE_BYTES;
  static_assert(LPK >= 1 && LPK <= 32 && 32 % LPK == 0, "hd / (16 bytes) must divide 32");
  static_assert(ROWS % 4 == 0, "a tile's scale slice must start on 16 bytes");
};

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

// spin until the phase of parity `parity` has completed; a wait that
// outlasts seconds is a broken pipeline, and traps rather than hang the card
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

// `bytes` (a multiple of 16) from device memory to shared memory, both on 16
// bytes, counted on the mbarrier `bar` when they land
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// the cluster barrier in two halves: every thread of every block of the
// cluster arrives (with release semantics, or none), then waits (acquire)
__device__ __forceinline__ void cluster_arrive(bool release) {
  if (release)
    asm volatile("barrier.cluster.arrive.release;" ::: "memory");
  else
    asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

// rank r's share [lo, hi) of the window [s0, e0) split n ways: ceil(len / n)
// rows each, in order, the last ones short or empty (ops/decode_attention.py
// `split_bounds`, the same formula)
__device__ __forceinline__ void share(int s0, int e0, int n, int r, int& lo, int& hi) {
  const int len = max(e0 - s0, 0);
  const int chunk = (len + n - 1) / n;
  lo = s0 + min(r * chunk, len);
  hi = s0 + min((r + 1) * chunk, len);
}

// T: q and o; C: the cache rows (T, or int8_t with row scales)
template <typename T, typename C, int D>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(const DecodeArgs a) {
  using L = Tile<C, D>;
  constexpr bool kInt8 = sizeof(C) == 1;
  constexpr int VEC = L::VEC, LPK = L::LPK, KPW = L::KPW;
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  __shared__ float sm_m[kWarps], sm_l[kWarps], sm_acc[kWarps][D];
  // rank 0's: each block's partial acc[D], m, l, written there by the block
  __shared__ float part[kMaxSplit][D + 2];

  cg::cluster_group cluster = cg::this_cluster();
  const int n = a.n_split, rank = static_cast<int>(cluster.block_rank());
  const int bh = blockIdx.x / n, b = bh / a.H, h = bh % a.H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane / LPK, sub = lane % LPK;
  float q[VEC];  // loaded beside start / end, not after them
  load_floats<T, VEC>(static_cast<const T*>(a.q.ptr) + b * a.q.sb + h * a.q.sh + sub * VEC, q);
  int lo, hi;
  share(max(a.start[b], 0), min(a.end[b], a.S), n, rank, lo, hi);
  if (n > 1) cluster_arrive(false);  // waited on before the partials go to rank 0
  const int t0 = lo & ~3;  // tiles start on a multiple of 4 rows
  const int tiles = hi > lo ? (hi - t0 + L::ROWS - 1) / L::ROWS : 0;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kWarps) {
    // the producer: one thread keeps kStages tiles in flight
    if (lane == 0) {
      const C* kb = static_cast<const C*>(a.k.ptr) + b * a.k.sb + h * a.k.sh;
      const C* vb = static_cast<const C*>(a.v.ptr) + b * a.v.sb + h * a.v.sh;
      const float* ksb = kInt8 ? static_cast<const float*>(a.ks.ptr) + b * a.ks.sb + h * a.ks.sh
                               : nullptr;
      const float* vsb = kInt8 ? static_cast<const float*>(a.vs.ptr) + b * a.vs.sb + h * a.vs.sh
                               : nullptr;
      for (int i = 0; i < tiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(smem_u32(&empty[s]), ((i / kStages) - 1) & 1);
        const int r0 = t0 + i * L::ROWS;                    // the tile's first row
        const int c0 = max(r0, lo), c1 = min(r0 + L::ROWS, hi);  // its rows in the share
        const uint32_t kv = static_cast<uint32_t>(c1 - c0) * L::ROW_BYTES;
        // the scale slice: from r0 (a multiple of 4) to c1 rounded up to one
        const uint32_t sc = kInt8 ? static_cast<uint32_t>((c1 - r0 + 3) & ~3) * 4u : 0u;
        const uint32_t bar = smem_u32(&full[s]);
        const uint32_t st = smem_u32(ring + s * L::STAGE_BYTES);
        mbar_expect_tx(bar, 2 * kv + 2 * sc);
        const uint32_t off = static_cast<uint32_t>(c0 - r0) * L::ROW_BYTES;
        bulk_load(st + off, kb + static_cast<long long>(c0) * D, kv, bar);
        bulk_load(st + L::KV_BYTES + off, vb + static_cast<long long>(c0) * D, kv, bar);
        if constexpr (kInt8) {
          bulk_load(st + 2 * L::KV_BYTES, ksb + r0, sc, bar);
          bulk_load(st + 2 * L::KV_BYTES + L::SCALE_BYTES, vsb + r0, sc, bar);
        }
      }
    }
  } else {
    const uint8_t* valid = a.mask == nullptr ? nullptr : a.mask + b * a.mask_sb;
#pragma unroll
    for (int e = 0; e < VEC; ++e) q[e] *= a.sm_scale * kLog2e;  // scores in the log2 domain

    float m = kNeg, l = 0.f, acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;

    // every lane of a warp runs the same tiles, so the shuffles see the warp
    for (int i = 0; i < tiles; ++i) {
      const int s = i % kStages;
      const int r0 = t0 + i * L::ROWS;
      int row[kUnroll];  // this lane group's rows in the tile
      bool ok[kUnroll];
      // the mask's loads go out before the wait for the tile
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        row[u] = u * kWarps * KPW + warp * KPW + grp;
        const int j = r0 + row[u];
        ok[u] = j >= lo && j < hi;
        if (valid != nullptr && ok[u]) ok[u] = __ldg(valid + j) != 0;
      }
      mbar_wait(smem_u32(&full[s]), (i / kStages) & 1);
      const unsigned char* st = ring + s * L::STAGE_BYTES;
      const float* kscale = reinterpret_cast<const float*>(st + 2 * L::KV_BYTES);
      const float* vscale = kscale + L::ROWS;
      float sc[kUnroll], tile_max = m;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float dot = 0.f;
        if (ok[u]) {
          float x[VEC];
          Vec<C>::unpack(*reinterpret_cast<const uint4*>(st + row[u] * L::ROW_BYTES + sub * 16),
                         x);
#pragma unroll
          for (int e = 0; e < VEC; ++e) dot += q[e] * x[e];
        }
#pragma unroll
        for (int off = LPK / 2; off > 0; off >>= 1)  // sum over the row's lanes
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if constexpr (kInt8) dot *= ok[u] ? kscale[row[u]] : 0.f;  // the key row's scale
        sc[u] = ok[u] ? dot : kNeg;
        tile_max = fmaxf(tile_max, sc[u]);
      }
      const float alpha = exp2f(m - tile_max);
      l *= alpha;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] *= alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!ok[u]) continue;
        const float p = exp2f(sc[u] - tile_max);
        float x[VEC];
        Vec<C>::unpack(
            *reinterpret_cast<const uint4*>(st + L::KV_BYTES + row[u] * L::ROW_BYTES + sub * 16),
            x);
        l += p;
        float pv = p;
        if constexpr (kInt8) pv *= vscale[row[u]];  // the value row's scale
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] += pv * x[e];
      }
      m = tile_max;
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(&empty[s]));  // this warp is done with the stage
    }

    // merge the lane groups of the warp (every lane ends with the warp's total)
#pragma unroll
    for (int off = LPK; off < 32; off <<= 1) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m, off);
      const float l_o = __shfl_xor_sync(0xffffffffu, l, off);
      const float mn = fmaxf(m, m_o), ca = exp2f(m - mn), cb = exp2f(m_o - mn);
      l = l * ca + l_o * cb;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float acc_o = __shfl_xor_sync(0xffffffffu, acc[e], off);
        acc[e] = acc[e] * ca + acc_o * cb;
      }
      m = mn;
    }
    if (grp == 0) {
      if (sub == 0) { sm_m[warp] = m; sm_l[warp] = l; }
#pragma unroll
      for (int e = 0; e < VEC; ++e) sm_acc[warp][sub * VEC + e] = acc[e];
    }
  }
  __syncthreads();
  if (n > 1) cluster_wait();  // every block of the cluster runs: rank 0's shared memory is there
  // merge the warps into this block's partial (the row itself without a
  // split), into its slot in rank 0's shared memory: one thread per element
  if (threadIdx.x < D) {
    float mx = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w]);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = exp2f(sm_m[w] - mx);
      lt += sm_l[w] * c;
      at += sm_acc[w][threadIdx.x] * c;
    }
    if (n == 1) {
      store(static_cast<T*>(a.o.ptr) + b * a.o.sb + h * a.o.sh + threadIdx.x,
            lt > 0.f ? at / lt : 0.f);
    } else {
      float* slot = cluster.map_shared_rank(&part[rank][0], 0);
      slot[threadIdx.x] = at;
      if (threadIdx.x == 0) { slot[D] = mx; slot[D + 1] = lt; }
    }
  }
  if (n == 1) return;
  cluster_arrive(true);  // release: the partial is in rank 0's shared memory
  if (rank != 0) return;  // nothing reads the other blocks' shared memory
  cluster_wait();
  if (threadIdx.x < D) {
    float mx = kNeg;
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r)
      if (r < n) mx = fmaxf(mx, part[r][D]);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) {
      if (r < n) {
        const float c = exp2f(part[r][D] - mx);
        lt += part[r][D + 1] * c;
        at += part[r][threadIdx.x] * c;
      }
    }
    store(static_cast<T*>(a.o.ptr) + b * a.o.sb + h * a.o.sh + threadIdx.x,
          lt > 0.f ? at / lt : 0.f);
  }
}

template <typename T, typename C, int D>
cudaError_t launch_kernel(const DecodeArgs& a, cudaStream_t stream) {
  auto kernel = decode_attention_kernel<T, C, D>;
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<C, D>::SMEM);
  if (set != cudaSuccess) return set;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B * a.H * a.n_split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Tile<C, D>::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.n_split > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, typename C>
cudaError_t launch_d(const DecodeArgs& a, cudaStream_t stream) {
  switch (a.D) {
    case 16: return launch_kernel<T, C, 16>(a, stream);
    case 32: return launch_kernel<T, C, 32>(a, stream);
    case 64: return launch_kernel<T, C, 64>(a, stream);
    case 128: return launch_kernel<T, C, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_t(const DecodeArgs& a, cudaStream_t stream) {
  if (a.int8_cache) {
    if (a.ks.ptr == nullptr || a.vs.ptr == nullptr) return cudaErrorInvalidValue;
    return launch_d<T, int8_t>(a, stream);
  }
  return launch_d<T, T>(a, stream);
}

}  // namespace

extern "C" int decode_cache_attention(const DecodeArgs* a, void* stream) {
  if (a->B <= 0 || a->H <= 0) return cudaSuccess;
  if (a->start == nullptr || a->end == nullptr || a->S <= 0 || a->n_split < 1 ||
      a->n_split > kMaxSplit || a->k.ss != a->D || a->v.ss != a->D)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a->dtype) {
    case 0: return launch_t<float>(*a, s);
    case 1: return launch_t<__nv_bfloat16>(*a, s);
    default: return cudaErrorInvalidValue;
  }
}
