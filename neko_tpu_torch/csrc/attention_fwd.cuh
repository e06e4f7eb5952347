// The causal attention forward that whole_head_attention.cu (#1, #3),
// blocked_attention.cu (#6) and ring_attention.cu (#11) launch: one kernel,
// three row-stat contracts and, for the ring, global coordinates.
//
//   p[r,c] = softmax_c( q[r,:] . k[c,:] * sm_scale ) over keys c with
//            c <= r and start[b] <= c < end[b]; fp32 softmax
//   out[r,:] = sum_c p[r,c] * keep_scale[r,c] * v[c,:]
//
// computed as the online softmax: per key tile, with the running max m and
// sum l, acc = acc * alpha + (exp(s - m) * keep_scale) v and out = acc / l.
// l sums exp(s - m) before the keep mask, so out is the dropout of the
// normalized probabilities.  In bf16, exp(s - m) * keep_scale is rounded to
// bf16 before the value product, as neko_tpu rounds p to the input dtype
// (attention_kernel.py:140, blocked_attention.py:226, ring_kernel.py:144);
// acc stays fp32.
//
// Row stats, per the pointers set in AttnArgs: lse = m + log(l) for the
// whole-head backward, or the running max m and the normalizer l (without
// the keep mask) for the blocked backward; with neither, none is written
// (the serving prefill).
//
// Ring mode (kRing): q and k, v are S-row blocks of a longer sequence at
// global offsets q_off and k_off.  The causal test, the key window and the
// keep mask take global rows and columns, so one seed drops the same elements
// whichever pair of blocks computes them; key tiles start at global multiples
// of the tile width (a multiple of the keep mask's 16-byte draws), so k_off
// may be any integer: the keys of a first tile that lie before k_off are
// loaded as zeros and masked.  The output is the fp32 accumulator, NOT
// divided by l, with (m, l): the partial of this pair, which the caller
// merges with those of the other kv blocks.
//
// What bounds it on the H100: the two products are 4 * hd FLOPs per visible
// (row, key) pair.  At the flagship train shape (B = 16, H = 24, S = 1024,
// hd = 32, causal) that is 25.8 GFLOP, 0.026 ms at the 989 TFLOP/s bf16
// tensor-core rate, against ~100 MB of q, k, v and out (0.03 ms at 3.35
// TB/s); at `long` (B = 8, S = 2048) 51.6 GFLOP: operations, barely.  At
// hd = 32 each product is only 32 deep or 32 wide, so per (row, key) pair
// the elementwise work (the exp, the masks, the keep byte, the bf16 pack)
// costs as much as the products; the design keeps it in registers.
//
// bf16 inputs run the tensor-core tile (namespace tc, on the primitives of
// attention_tc.cuh), for hd in {16, 32, 64, 128}, compiled per hd:
//
// * one block of four warps per 64-row q tile, a warp per 16 rows, whose q
//   fragments are loaded once by ldmatrix and kept in registers;
// * 64-key k and v tiles, bf16 in shared memory with padded rows, arrive by
//   16-byte cp.async copies through a two-stage ring: the next tile's copies
//   are in flight while this tile's products run;
// * s = q k^T is mma.sync.m16n8k16 (k the B operand, by ldmatrix), and the
//   softmax runs on its accumulator fragments: the row max over the quad of
//   lanes that share a row (two shuffles), exp2 with sm_scale * log2(e)
//   folded into one FMA, acc rescaled once a tile, each lane's share of l
//   added up over the quad once, at the end;
// * p * keep goes to bf16 straight into the A operand of acc += p v: the
//   accumulator layout of two adjacent n8 tiles is the A layout of one k16
//   step, so p never touches shared memory; v is the B operand by
//   ldmatrix.trans;
// * the keep bytes: a warp draws the Philox blocks its 16 rows x 64 keys
//   cover, once a tile, into per-warp words that its lanes read in the
//   fragment's (row, key) layout (as the backward's dq tile does);
// * the masks are applied only on the tiles that cross a warp's diagonal or
//   the key window's ends, and a warp skips a tile that lies wholly above
//   its rows;
// * at hd = 128 a warp walks a key tile in two passes of 32 keys, so that s
//   leaves room for the 64 fp32 accumulators a thread.
//
// fp32 inputs run the CUDA-core kernel (namespace f32; hd in {32, 64, 128},
// the wrappers pad hd 16 to 32): no tensor-core fp32 product exists without
// TF32's loss of precision, and no train path runs fp32 on the card.  One
// block per (64-row q tile, head, batch) loops over 32-key tiles in shared
// memory, a warp per 8 rows and a lane per key, with p kept in fp32.
//
// Causal imbalance: the last q tile visits every key tile and the first one
// tile.  The q tile is the slowest grid dimension, reversed, so the blocks of
// the heaviest tiles (of every head and batch row) start first and the light
// ones fill the tail.
//
// Fill and empty rows: masked logits take the finite fill -1e30 and masked
// probabilities are exactly 0 (a row that has seen no key keeps m = -1e30,
// and its terms come out as exp2(-1e30 * scale) = 0), so a row whose visited
// key set is empty keeps l = 0 and writes o = 0, lse = 0, m = -1e30 and
// l = 0, never NaN.

#pragma once

#include <initializer_list>
#include <type_traits>

#include "attention_common.cuh"
#include "attention_tc.cuh"

namespace {

using namespace whk;

namespace fwd {

// ------------------------------------------------ fp32: the CUDA-core kernel
namespace f32 {


constexpr int kBlockM = 64;  // query rows per block
constexpr int kBlockN = 32;  // keys per tile (one key per lane)
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = kBlockM / kWarps;

template <int D>
constexpr int smem_floats() {
  // q tile [kBlockM][D], k tile [kBlockN][D + 1] (padded: lane j reads row j
  // with no bank conflict), v tile [kBlockN][D]
  return kBlockM * D + kBlockN * (D + 1) + kBlockN * D;
}

// kDrop: dropout on (the instantiation without it carries no Philox code and
// no keep-mask registers).  One block an SM is all the bound asks, which
// leaves ptxas up to 255 registers: on an H100 build, asking for three or
// four blocks at D = 32 (at most 80 or 64 registers), or for nothing (80 at
// D = 64), spilled registers in fp32.
template <typename T, int D, bool kDrop, bool kRing>
__global__ void __launch_bounds__(kWarps * 32, 1)
attention_fwd_kernel(const AttnArgs a) {
  using TO = std::conditional_t<kRing, float, T>;  // the ring partial is fp32
  static_assert(D % 32 == 0, "head dim must be a multiple of 32");
  constexpr int kDL = D / 32;  // output dims per lane
  constexpr int kKP = D + 1;   // padded k row stride
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + kBlockM * D;
  float* sv = sk + kBlockN * kKP;
  __shared__ uint32_t keep_words[kWarps][kRowsPerWarp][kBlockN / 4];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int r0 = (gridDim.z - 1 - blockIdx.z) * kBlockM;  // heaviest q tile first
  const int S = a.S;
  const T* __restrict__ q = head_ptr<T>(a.q, b, h);
  const T* __restrict__ k = head_ptr<T>(a.k, b, h);
  const T* __restrict__ v = head_ptr<T>(a.v, b, h);
  TO* __restrict__ out = head_ptr<TO>(a.o, b, h);
  const long long bh_row = static_cast<long long>(b * a.H + h) * S;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // global offsets of local row 0 and local key 0 (0 outside the ring)
  const int q_off = kRing ? a.q_off : 0;
  const int k_off = kRing ? a.k_off : 0;
  const int st = max(a.start[b], 0);
  const int en = kRing ? a.end[b] : min(a.end[b], S);
  // keys this q tile can see, as global columns: [st, min(en, r_end)) --
  // causal bound col <= row -- within the kv block [k_off, k_off + S)
  const int c_end = min(min(en, k_off + S), q_off + min(r0 + kBlockM, S));
  const int c_beg = (max(st, k_off) / kBlockN) * kBlockN;
  const uint32_t seed = kDrop ? static_cast<uint32_t>(a.seed[0]) : 0u;
  const uint32_t bh = static_cast<uint32_t>(b * a.H + h);

  for (int i = tid; i < kBlockM * D; i += blockDim.x) {
    const int r = r0 + i / D;
    sq[i] = r < S ? load(&q[r * a.q.ss + i % D]) : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDL];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDL; ++j) acc[i][j] = 0.f;
  }
  const int row0 = warp * kRowsPerWarp;  // this warp's first row in the tile

  for (int c0 = c_beg; c0 < c_end; c0 += kBlockN) {
    __syncthreads();  // previous tile fully consumed (and q tile written)
    for (int i = tid; i < kBlockN * D; i += blockDim.x) {
      const int c = c0 - k_off + i / D, d = i % D;  // local key
      float kx = 0.f, vx = 0.f;
      // one branch for both loads, so their latencies overlap
      if ((!kRing || c >= 0) && c < S) {
        kx = load(&k[c * a.k.ss + d]);
        vx = load(&v[c * a.v.ss + d]);
      }
      sk[(i / D) * kKP + d] = kx;
      sv[i] = vx;
    }
    if constexpr (kDrop)
      draw_keep_words(keep_words[warp], seed, bh, q_off + r0 + row0, c0, lane);
    __syncthreads();

    const int c = c0 + lane;  // this lane's key (global column)
    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kd = sk[lane * kKP + d];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) s[i] = fmaf(sq[(row0 + i) * D + d], kd, s[i]);
    }

    float p[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = r0 + row0 + i;
      bool ok = c <= q_off + r && c >= st && c < en && r < S;
      if constexpr (kRing) ok = ok && c >= k_off && c < k_off + S;
      const float si = ok ? s[i] * a.sm_scale : kNeg;
      const float m_new = fmaxf(m[i], warp_max(si));
      p[i] = ok ? expf(si - m_new) : 0.f;
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + warp_sum(p[i]);  // l before the keep mask
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kDL; ++j) acc[i][j] *= alpha;
      if constexpr (kDrop)
        p[i] = keep_byte(keep_words[warp], i, lane) >= a.drop_threshold ? p[i] * a.drop_scale
                                                                         : 0.f;
    }

#pragma unroll 4
    for (int j = 0; j < kBlockN; ++j) {
      float vj[kDL];
#pragma unroll
      for (int t = 0; t < kDL; ++t) vj[t] = sv[j * D + lane + 32 * t];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float pj = __shfl_sync(0xffffffffu, p[i], j);
#pragma unroll
        for (int t = 0; t < kDL; ++t) acc[i][t] = fmaf(pj, vj[t], acc[i][t]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = r0 + row0 + i;
    if (r >= S) continue;
    const float inv = kRing ? 1.f : l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int t = 0; t < kDL; ++t) store(&out[r * a.o.ss + lane + 32 * t], acc[i][t] * inv);
    if (lane == 0) {
      if (a.lse != nullptr) a.lse[bh_row + r] = l[i] > 0.f ? m[i] + logf(l[i]) : 0.f;
      if (a.m != nullptr) {
        a.m[bh_row + r] = m[i];
        a.l[bh_row + r] = l[i];
      }
    }
  }
}

}  // namespace f32

// ------------------------------------------------ bf16: the tensor-core tile
namespace tc {

using namespace ::tc;

// keys a pass over s takes: the whole 64-key tile, or half of it at hd 128,
// where the accumulator alone holds 64 fp32 registers a thread
template <int D>
__host__ __device__ constexpr int pass_keys() {
  return D >= 128 ? 32 : 64;
}

template <int D>
__host__ __device__ constexpr int smem_bytes() {
  constexpr int P = D + kPad;
  // q [kRows][P]; k, v [2 stages][kKeys][P]; keep words [kWarps][16][16]
  return (kRows * P + 4 * kKeys * P) * 2 + kWarps * 16 * 16 * 4;
}

// o (or the ring's acc) and the row stats of one 64-row q tile, over the
// 64-key tiles at or below the diagonal.
template <int D, bool kDrop, bool kRing>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const AttnArgs a) {
  static_assert(D % 16 == 0 && D <= 128, "head dim");
  using TO = std::conditional_t<kRing, float, bf16>;  // the ring partial is fp32
  constexpr int P = D + kPad;
  constexpr int kPass = pass_keys<D>();
  constexpr int NT = kPass / 8;   // n8 tiles of s (keys) a pass
  constexpr int KK = kPass / 16;  // k steps over the keys a pass
  constexpr int DT = D / 8;       // n8 tiles of acc (dims)
  constexpr int KD = D / 16;      // k steps over the head dim
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* sq = reinterpret_cast<bf16*>(tc_smem);
  bf16* sk = sq + kRows * P;      // [2][kKeys][P]
  bf16* sv = sk + 2 * kKeys * P;  // [2][kKeys][P]
  auto keep = reinterpret_cast<uint32_t(*)[16][16]>(sv + 2 * kKeys * P);  // [kWarps]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int r0 = (gridDim.z - 1 - blockIdx.z) * kRows;  // heaviest q tile first
  const int S = a.S;
  const bf16* q = head_ptr<bf16>(a.q, b, h);
  const bf16* k = head_ptr<bf16>(a.k, b, h);
  const bf16* v = head_ptr<bf16>(a.v, b, h);
  const long long bh_row = static_cast<long long>(b * a.H + h) * S;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  // global offsets of local row 0 and local key 0 (0 outside the ring)
  const int q_off = kRing ? a.q_off : 0;
  const int k_off = kRing ? a.k_off : 0;
  const int st = max(a.start[b], 0);
  const int en = kRing ? a.end[b] : min(a.end[b], S);
  // the keys a row may see, as global columns [lo, hi): the key window within
  // the kv block; and the key tiles this q tile sees (causal: col <= row)
  const int lo = max(st, k_off), hi = min(en, k_off + S);
  const int c_end = min(hi, q_off + min(r0 + kRows, S));
  const int c_beg = (lo / kKeys) * kKeys;
  const uint32_t seed = kDrop ? static_cast<uint32_t>(a.seed[0]) : 0u;
  const uint32_t bh = static_cast<uint32_t>(b * a.H + h);
  // exp(x * sm_scale) = exp2(x * sm_scale * log2(e))
  const float scale_log2 = a.sm_scale * kLog2e;

  load_rows<kRows, D>(sq, q, a.q.ss, r0, S);
  cp_async_commit();
  auto load_kv = [&](int c, int stage) {
    load_rows<kKeys, D>(sk + stage * kKeys * P, k, a.k.ss, c - k_off, S);
    load_rows<kKeys, D>(sv + stage * kKeys * P, v, a.v.ss, c - k_off, S);
  };
  if (c_beg < c_end) load_kv(c_beg, 0);
  cp_async_commit();

  // this warp's rows: local w_row .. w_row + 15; this lane's: row0 (+ 8)
  const int w_row = r0 + warp * 16;
  const int row0 = w_row + g;
  cp_async_wait<1>();
  __syncthreads();  // the q tile has landed
  uint32_t aq[KD][4];
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) ldsm(aq[kd], a_addr(sq, P, warp * 16, kd * 16, lane));

  // per row (g, g + 8): the running max of the raw scores q . k (sm_scale > 0
  // keeps their order), and this lane's share of l, which rescales with the
  // others' and is added up over the quad at the end
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  int stage = 0;
  for (int c0 = c_beg; c0 < c_end; c0 += kKeys, stage ^= 1) {
    if (c0 + kKeys < c_end) load_kv(c0 + kKeys, stage ^ 1);
    cp_async_commit();
    // a warp whose rows all lie before the tile's first key (or past S) has
    // nothing to add from it
    const bool active = w_row < S && c0 <= q_off + w_row + 15;
    if (kDrop && active) {  // the 16 rows x 4 column blocks of this warp's fragments
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int d = lane + 32 * i, rw = d >> 2, blk = d & 3;
        *reinterpret_cast<uint4*>(&keep[warp][rw][4 * blk]) = philox4x32_10(
            make_uint4(static_cast<uint32_t>(c0 / 16 + blk),
                       static_cast<uint32_t>(q_off + w_row + rw), 0u, 0u),
            make_uint2(seed, bh));
      }
    }
    cp_async_wait<1>();
    __syncthreads();  // this key tile has landed (and the keep words are written)
    if (active) {
      const bf16* tk = sk + stage * kKeys * P;
      const bf16* tv = sv + stage * kKeys * P;
      // masks only on a tile that crosses the warp's diagonal or the window's ends
      const bool edge = c0 + kKeys - 1 > q_off + w_row || c0 < lo || c0 + kKeys > hi;
#pragma unroll
      for (int pass = 0; pass < kKeys / kPass; ++pass) {
        const int n0 = pass * kPass;  // the pass's first key in the tile
        // s = q k^T: this warp's 16 rows x kPass keys
        float s[NT][4];
#pragma unroll
        for (int i = 0; i < NT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
          for (int nt = 0; nt < NT; nt += 2) {
            uint32_t bk[4];
            ldsm(bk, bt_addr(tk, P, n0 + nt * 8, kd * 16, lane));
            mma(s[nt], aq[kd], bk[0], bk[1]);
            mma(s[nt + 1], aq[kd], bk[2], bk[3]);
          }
        }
        if (edge) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = c0 + n0 + nt * 8 + 2 * t + (e & 1);  // global column
              const int row = q_off + row0 + 8 * (e >> 1);          // global row
              if (!(col <= row && col >= lo && col < hi)) s[nt][e] = kNeg;
            }
        }
        // the new running max, over the quad of lanes that share a row; acc
        // and l rescale once
        float mx[2] = {m[0], m[1]}, mc[2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
          mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
          const float alpha = exp2f((m[hh] - mx[hh]) * scale_log2);
          m[hh] = mx[hh];
          l[hh] *= alpha;
#pragma unroll
          for (int dt = 0; dt < DT; ++dt) {
            acc[dt][2 * hh] *= alpha;
            acc[dt][2 * hh + 1] *= alpha;
          }
          // a row that has seen no key keeps m = -1e30: its masked terms must
          // come out as exp2(-1e30 * scale) = 0, not exp2(0)
          mc[hh] = mx[hh] == kNeg ? 0.f : mx[hh] * scale_log2;
        }
        // p = exp(s * sm_scale - m) into l (before the keep mask), then
        // p * keep rounded to bf16 straight into the A operand of acc += p v:
        // the accumulator fragments of n8 tiles 2kk and 2kk + 1 are the A
        // operand of k step kk
        uint32_t ap[KK][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int ntt = n0 / 8 + nt;  // n8 tile in the 64-key tile
          float y[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = exp2f(fmaf(s[nt][e], scale_log2, -mc[e >> 1]));
            l[e >> 1] += p;
            y[e] = p;
            if constexpr (kDrop)
              y[e] = byte_of(keep[warp][g + 8 * (e >> 1)][2 * ntt + (t >> 1)],
                             2 * (t & 1) + (e & 1)) >= a.drop_threshold
                         ? p * a.drop_scale
                         : 0.f;
          }
          ap[nt >> 1][(nt & 1) * 2] = pack_bf16(y[0], y[1]);
          ap[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(y[2], y[3]);
        }
        // acc += (p keep) v
#pragma unroll
        for (int kk = 0; kk < KK; ++kk) {
#pragma unroll
          for (int dt = 0; dt < DT; dt += 2) {
            uint32_t bv[4];
            ldsm_t(bv, b_addr(tv, P, n0 + kk * 16, dt * 8, lane));
            mma(acc[dt], ap[kk], bv[0], bv[1]);
            mma(acc[dt + 1], ap[kk], bv[2], bv[3]);
          }
        }
      }
    }
    __syncthreads();  // this stage is free for the next key tile
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {  // the row sums over the quad
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
  TO* out = head_ptr<TO>(a.o, b, h);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + 8 * hh;
    if (r >= S) continue;
    const float inv = kRing ? 1.f : l[hh] > 0.f ? 1.f / l[hh] : 0.f;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      store2(&out[r * a.o.ss + dt * 8 + 2 * t], acc[dt][2 * hh] * inv, acc[dt][2 * hh + 1] * inv);
    if (t == 0) {
      // m of the scaled scores, as the contract has it; -1e30 on a row that
      // saw no key
      const float m_out = l[hh] > 0.f ? m[hh] * a.sm_scale : kNeg;
      if (a.lse != nullptr) a.lse[bh_row + r] = l[hh] > 0.f ? m_out + logf(l[hh]) : 0.f;
      if (a.m != nullptr) {
        a.m[bh_row + r] = m_out;
        a.l[bh_row + r] = l[hh];
      }
    }
  }
}

}  // namespace tc

template <typename T, int D, bool kDrop, bool kRing>
cudaError_t launch(const AttnArgs& a, cudaStream_t stream) {
  constexpr bool kTc = std::is_same_v<T, __nv_bfloat16>;
  constexpr int kRowsBlock = kTc ? tc::kRows : f32::kBlockM;
  size_t smem;
  void (*kernel)(const AttnArgs);
  if constexpr (kTc) {
    smem = tc::smem_bytes<D>();
    kernel = tc::attention_fwd_kernel<D, kDrop, kRing>;
  } else {
    smem = f32::smem_floats<D>() * sizeof(float);
    kernel = f32::attention_fwd_kernel<T, D, kDrop, kRing>;
  }
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.H, a.B, (a.S + kRowsBlock - 1) / kRowsBlock);
  kernel<<<grid, kTc ? tc::kThreads : f32::kWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

// Head dims: bf16 16, 32, 64, 128 (the tensor-core tile); fp32 32, 64, 128.
template <typename T, bool kDrop, bool kRing>
cudaError_t dispatch_d(const AttnArgs& a, cudaStream_t stream) {
  switch (a.D) {
    case 16:
      if constexpr (std::is_same_v<T, __nv_bfloat16>) return launch<T, 16, kDrop, kRing>(a, stream);
      return cudaErrorInvalidValue;
    case 32: return launch<T, 32, kDrop, kRing>(a, stream);
    case 64: return launch<T, 64, kDrop, kRing>(a, stream);
    case 128: return launch<T, 128, kDrop, kRing>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, bool kRing>
cudaError_t dispatch_drop(const AttnArgs& a, cudaStream_t stream) {
  return a.drop_threshold > 0 ? dispatch_d<T, true, kRing>(a, stream)
                              : dispatch_d<T, false, kRing>(a, stream);
}

}  // namespace fwd

// The forward on the arguments' dtype (0 = float32, 1 = bfloat16); kRing:
// the ring partial (global offsets, fp32 unnormalized output).  The bf16
// tile copies q, k, v 16 bytes at a time and stores two outputs at a time:
// their views need 16-byte aligned pointers and strides that are multiples
// of 8 elements, the output's an aligned pointer and even strides.
template <bool kRing = false>
int attention_fwd(const AttnArgs* a, void* stream) {
  if (a->B <= 0 || a->H <= 0 || a->S <= 0) return cudaSuccess;
  if (a->drop_threshold > 0 && a->seed == nullptr) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a->dtype) {
    case 0: return fwd::dispatch_drop<float, kRing>(*a, s);
    case 1:
      for (const View* v : {&a->q, &a->k, &a->v})
        if (!tc::aligned(*v, 16, 8)) return cudaErrorMisalignedAddress;
      if (!tc::aligned(a->o, kRing ? 8 : 4, 2)) return cudaErrorMisalignedAddress;
      return fwd::dispatch_drop<__nv_bfloat16, kRing>(*a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
