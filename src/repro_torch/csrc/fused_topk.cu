// fused_screened_topk: gather + tile logits + sentinel mask + top-k + log Z
// over each query row's K candidate tiles, in one launch. Only ids (B, k),
// vals (B, k) and logZ (B,) reach the caller; the (B, K*128) candidate-logit
// row is never written, only each part's short top list and (max, sum-exp).
//
// Replaces the Pallas kernel src/repro/kernels/fused_topk.py::
// fused_screened_topk (_fused_topk_kernel and _merge_topk, pl.pallas_call at
// fused_topk.py:193). On the TPU the grid (B, K) runs in order on one core and
// VMEM scratch carries the running top-k and the (max, sum-exp) pair from
// slot j to slot j+1. A CUDA grid has no order, and a loop over the K slots
// inside one block per row would leave all but B of the 132 SMs idle at
// decode batch sizes.
//
// Bound on the H100: bytes. The call streams its distinct valid candidate
// tiles (128 x d floats each, 256,000 bytes at d = 500) for 2 flops per
// weight; everything else is a few KB.
//
// Two grids, one algorithm; the wrapper (kernels/fused_topk.py) picks one by
// the batch B it is given:
//
// * The per-row grid (K * P, B), for B below the crossover B0 = 128 and for
//   calls that carry no routes (the adaptive head's tiers, a shard's call).
//   Block (part p, slot j, row i) owns rows [p*R, (p+1)*R) of slot j's tile,
//   R = 128 / P, with P chosen by the wrapper so that B * K * P blocks cover
//   the SMs (P = 8 at B = 4, K = 16: 512 blocks). At decode widths rows
//   rarely share a tile, and a block per row is what fills the card.
// * The grouped grid (P, chunks), for B >= B0 when the rows' routes are
//   known. At a translation batch (640 rows, K = 9, d = 500) the per-row
//   grid streams each tile once per (row, slot) that needs it: 1.47 GB
//   through L2 a call. group_rows_kernel (one block) groups the rows by
//   cluster and, through the clusters' candidate blocks, the B * K (row,
//   slot) pairs by tile, and cuts each tile's pairs into chunks of up to
//   G = FT_GROUP: rows of one cluster share all K tiles, rows of different
//   clusters share the tiles their clusters share (5,760 pairs over 195
//   tiles: 449 chunks, where chunks of one cluster's rows would be 882).
//   Block (part p, chunk c) stages its pairs' rows of h once and streams
//   its part of the tile once against all of them: each warp keeps
//   FT_RING - 1 steps of FT_WROWS weight rows in flight with cp.async and
//   multiplies each against every row of h. The grid has room for
//   ceil(B K / G) + min(n_blk + 1, B K) chunks whatever the routes, so a
//   CUDA graph captures it once; blocks past the last chunk exit at once.
//
// Both grids give each (row, slot, part) the same bits:
//   Phase A:
//   1. a valid slot computes the part's R logits with l2s_tile_logits'
//      summation order (lane l accumulates chunks l, l+32, ... with fmaf,
//      then the xor butterfly; the grouped grid keeps that tree, reducing
//      its warp's FT_WROWS x G sums together, each lane keeping half and
//      sending half at each step), so its logits are the bits screen.cu
//      gives; a sentinel slot reads no weights at all;
//   2. one warp reduces the part's (max, sum-exp) over its R logits; a
//      sentinel part gives (-inf, 0);
//   3. with noise, noise[i, j, row] is added after that (Gumbel-max sampling
//      keeps log Z exact);
//   4. the first kk = min(k, R) of the R values by (value desc, position
//      asc), position = j*128 + row, land in the part's sorted list: each
//      value finds its rank (per-row grid; grouped grid for kk > FT_SELECT)
//      or one warp takes kk rounds of an argmax (grouped grid, short lists);
//      a sentinel part lists (NEG_INF, its first kk positions), as a stable
//      sort of the masked unfused row would order them;
//   5. the list and the pair go to scratch under the row's own index,
//      __threadfence(), and one atomic increment of row i's counter.
//   Phase B, the block that brings row i's counter to K * P (the last of the
//   row to finish) resets it to 0 for the next launch and merges the row
//   (a grouped block may merge several rows, one per pair of warps at once):
//   - log Z: the K * P pairs are combined by one warp in a fixed order (the
//     global max, then lane-strided sums of s * exp(m - max) and an xor
//     butterfly; no float atomics), so logZ is the same from run to run and
//     -inf for an all-sentinel row;
//   - top-k: the K * P sorted lists are merged by one warp in k rounds:
//     each lane holds the best head of its lists, a butterfly argmax by
//     (value desc, position asc) picks the round's winner, and its owner
//     lane advances that list. Positions are unique, so the order is total
//     and ties go to the lowest flattened (slot-major, lane-minor) position,
//     as jax.lax.top_k breaks them over the unfused row. Word ids are
//     rebuilt from the position: block*128 + lane, or n_blk*128 at a
//     sentinel slot.
// So at equal P the two grids give bit-identical ids, vals and logZ.
// Shared memory in phase B holds only each list's head index, the value and
// position at its head, its max and its sum (20 bytes a list: 40 KB at
// K*P = 2,000); an advanced list's next entry is read from the scratch in L2
// (__ldcg), where the blocks of phase A left it. So every k <= K*128 is
// served, for K*P up to 11,622 lists; the lists themselves (8 bytes an
// entry) pass 227 KB from K >= 225 tiles at k >= 128.
//
// The weights and h come in float32 or in bfloat16 (fused_topk_kernel and
// fused_topk_bf16_kernel, one body, and their _grouped twins, which take
// rows of whole 16-byte chunks): the logits, the noise, the lists and the
// outputs are float32 either way, and bfloat16 logits are the bits
// screen.cu's bfloat16 kernel gives.
#include <limits.h>

#include "l2s_common.cuh"

#define FT_THREADS 256   // 8 warps: R = 16..128 rows a block, 2..16 per warp
#define FT_SMEM_OPTIN (227 * 1024)   // shared memory one block may opt into
#define FT_GROUP 16      // G: (row, slot) pairs of one tile a grouped block serves
#define FT_WROWS 4       // weight rows a warp of a grouped block streams at once
#define FT_RING 4        // its ring of cp.async steps (FT_RING - 1 in flight)
#define FT_MERGE_PAIRS 4 // rows a grouped block merges at once (a pair of warps each)
#define FT_SELECT 8      // lists this short a grouped block selects by warp argmax
#define GR_THREADS 1024  // group_rows_kernel's one block

__device__ __forceinline__ bool ft_before(float v, int p, float ov, int op) {
  return v > ov || (v == ov && p < op);
}

// ---- phase B, shared by both grids. s holds 5 L words: each list's head
// index, the value and position at its head, the part's max and its sum.
__device__ __forceinline__ void ft_merge_load(int i, int L, int kk,
                                              const float* __restrict__ part_v,
                                              const int* __restrict__ part_p,
                                              const float* __restrict__ part_m,
                                              const float* __restrict__ part_s, float* s,
                                              int tt, int nt) {
  const size_t q0 = (size_t)i * L;
  const float* gv = part_v + q0 * kk;        // the row's L lists of kk, list-major
  const int* gp = part_p + q0 * kk;
  int* head = reinterpret_cast<int*>(s);     // L: next entry of each list
  float* hv = reinterpret_cast<float*>(head + L);  // L: its value (-inf: spent)
  int* hp = reinterpret_cast<int*>(hv + L);  // L: its position (INT_MAX: spent)
  float* lm = reinterpret_cast<float*>(hp + L);  // L part maxima
  float* ls = lm + L;                        // L part sums
  for (int l = tt; l < L; l += nt) {
    head[l] = 0;
    hv[l] = __ldcg(gv + (size_t)l * kk);
    hp[l] = __ldcg(gp + (size_t)l * kk);
    lm[l] = __ldcg(part_m + q0 + l);
    ls[l] = __ldcg(part_s + q0 + l);
  }
}

__device__ __forceinline__ void ft_merge_logz(int i, int L, const float* s, int lane,
                                              float* __restrict__ out_logz) {
  const float* lm = s + 3 * L;
  const float* ls = s + 4 * L;
  float m = -INFINITY;
  for (int l = lane; l < L; l += 32) m = fmaxf(m, lm[l]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  float sum = 0.f;
  for (int l = lane; l < L; l += 32)
    if (lm[l] > -INFINITY) sum += ls[l] * expf(lm[l] - m);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) out_logz[i] = m + logf(sum);  // -inf + log 0 = -inf: all sentinel
}

__device__ __forceinline__ void ft_merge_topk(int i, int L, int kk, int k, int K, int n_blk,
                                              const int* __restrict__ ids,
                                              const float* __restrict__ part_v,
                                              const int* __restrict__ part_p, float* s,
                                              int lane, int* __restrict__ out_ids,
                                              float* __restrict__ out_vals) {
  const size_t q0 = (size_t)i * L;
  const float* gv = part_v + q0 * kk;
  const int* gp = part_p + q0 * kk;
  int* head = reinterpret_cast<int*>(s);
  float* hv = reinterpret_cast<float*>(head + L);
  int* hp = reinterpret_cast<int*>(hv + L);
  // lane-local best head over lists lane, lane + 32, ...
  float bv = -INFINITY;
  int bp = INT_MAX, bl = -1;
  for (int l = lane; l < L; l += 32) {
    if (ft_before(hv[l], hp[l], bv, bp)) {
      bv = hv[l];
      bp = hp[l];
      bl = l;
    }
  }
  const int sentinel = n_blk * L2S_V_BLK;
  for (int r = 0; r < k; ++r) {
    float wv = bv;
    int wp = bp, wl = bl;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, wv, off);
      const int op = __shfl_xor_sync(0xffffffffu, wp, off);
      const int ol = __shfl_xor_sync(0xffffffffu, wl, off);
      if (ft_before(ov, op, wv, wp)) {
        wv = ov;
        wp = op;
        wl = ol;
      }
    }
    if (lane == 0) {
      const int slot_blk = ids[(size_t)i * K + (wp >> 7)];
      out_vals[(size_t)i * k + r] = wv;
      out_ids[(size_t)i * k + r] = slot_blk >= 0 && slot_blk < n_blk
                                       ? slot_blk * L2S_V_BLK + (wp & (L2S_V_BLK - 1))
                                       : sentinel;
    }
    if (r + 1 < k && wl >= 0 && (wl & 31) == lane) {  // the owner advances the list
      const int hd = ++head[wl];
      float nv = -INFINITY;
      int np = INT_MAX;
      if (hd < kk) {
        nv = __ldcg(gv + (size_t)wl * kk + hd);
        np = __ldcg(gp + (size_t)wl * kk + hd);
      }
      hv[wl] = nv;
      hp[wl] = np;
      bv = -INFINITY;
      bp = INT_MAX;
      bl = -1;
      for (int l = lane; l < L; l += 32) {
        if (ft_before(hv[l], hp[l], bv, bp)) {
          bv = hv[l];
          bp = hp[l];
          bl = l;
        }
      }
    }
  }
}

// (max, sum-exp) of R logits by one warp, in a fixed order.
__device__ __forceinline__ void ft_part_pair(const float* x, int R, int lane, float& m,
                                             float& s) {
  m = -INFINITY;
  for (int r = lane; r < R; r += 32) m = fmaxf(m, x[r]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  s = 0.f;
  for (int r = lane; r < R; r += 32) s += expf(x[r] - m);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
}

// The first kk of R values x (position first + r) by (value desc, position
// asc), sorted, by one warp in kk rounds: each lane holds its best untaken
// value of r = lane, lane + 32, ..., a butterfly argmax picks the round's
// winner, and its lane marks it taken. The list the rank of every value
// gives, for short lists at the cost of kk argmaxes.
__device__ __forceinline__ void ft_select(const float* x, int R, int kk, int first, int lane,
                                          float* __restrict__ pv, int* __restrict__ pp) {
  unsigned taken = 0u;                       // bit i: r = lane + 32 i is listed
  for (int round = 0; round < kk; ++round) {
    float bv = -INFINITY;
    int br = INT_MAX;
    for (int i = 0, r = lane; r < R; ++i, r += 32) {
      if (!((taken >> i) & 1u) && ft_before(x[r], r, bv, br)) {
        bv = x[r];
        br = r;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int orr = __shfl_xor_sync(0xffffffffu, br, off);
      if (ft_before(ov, orr, bv, br)) {
        bv = ov;
        br = orr;
      }
    }
    if (lane == 0) {
      pv[round] = bv;
      pp[round] = first + br;
    }
    if ((br & 31) == lane) taken |= 1u << (br >> 5);
  }
}

// ---- the per-row grid
template <typename T>
__device__ __forceinline__ void fused_topk_body(
    const T* __restrict__ W, const T* __restrict__ b, const T* __restrict__ h,
    const int* __restrict__ ids, const float* __restrict__ noise,
    float* __restrict__ part_v, int* __restrict__ part_p, float* __restrict__ part_m,
    float* __restrict__ part_s, unsigned* __restrict__ count, int* __restrict__ out_ids,
    float* __restrict__ out_vals, float* __restrict__ out_logz, int K, int n_blk, int d,
    int k, int P, int kk) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  __shared__ bool am_last;

  const int R = L2S_V_BLK / P;
  const int L = K * P;                       // lists (parts) of one row
  const int i = blockIdx.y;
  const int j = blockIdx.x / P;
  const int p = blockIdx.x - j * P;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int blk = ids[(size_t)i * K + j];
  const bool valid = blk >= 0 && blk < n_blk;
  const int first = j * L2S_V_BLK + p * R;   // position of the part's row 0
  const size_t q = (size_t)i * L + blockIdx.x;
  float* pv = part_v + q * kk;
  int* pp = part_p + q * kk;

  // ---- phase A: this part's logits, (max, sum-exp) and sorted top-kk list
  if (valid) {                               // uniform over the block
    float* h_s = sm;                         // d (rounded to float4)
    float* x = h_s + ((d + 3) & ~3);         // R logits
    const size_t row0 = (size_t)blk * L2S_V_BLK + p * R;
    l2s_stage(h + (size_t)i * d, h_s, d);
    __syncthreads();
    l2s_tile_logits(W + row0 * d, b + row0, h_s, d, x, R);
    __syncthreads();
    if (warp == 0) {
      float m, s;
      ft_part_pair(x, R, lane, m, s);
      if (lane == 0) {
        part_m[q] = m;
        part_s[q] = s;
      }
    }
    float v = 0.f;
    if (t < R)
      v = noise ? x[t] + __ldg(noise + ((size_t)i * K + j) * L2S_V_BLK + p * R + t)
                : x[t];
    __syncthreads();                         // warp 0 has read the raw logits
    if (t < R) x[t] = v;
    __syncthreads();
    if (t < R) {
      int rank = 0;
      for (int u = 0; u < R; ++u) rank += ft_before(x[u], u, v, t);
      if (rank < kk) {
        pv[rank] = v;
        pp[rank] = first + t;
      }
    }
  } else {
    for (int r = t; r < kk; r += blockDim.x) {
      pv[r] = L2S_NEG_INF;
      pp[r] = first + r;
    }
    if (t == 0) {
      part_m[q] = -INFINITY;
      part_s[q] = 0.f;
    }
  }

  // ---- the last block of row i to finish merges the row
  __threadfence();
  __syncthreads();
  if (t == 0) {
    am_last = atomicAdd(count + i, 1u) == (unsigned)(L - 1);
    if (am_last) count[i] = 0u;              // every block of the row has counted
  }
  __syncthreads();
  if (!am_last) return;
  __threadfence();
  ft_merge_load(i, L, kk, part_v, part_p, part_m, part_s, sm, t, blockDim.x);
  __syncthreads();
  if (warp == 1)
    ft_merge_logz(i, L, sm, lane, out_logz);
  else if (warp == 0)
    ft_merge_topk(i, L, kk, k, K, n_blk, ids, part_v, part_p, sm, lane, out_ids, out_vals);
}

// ---- the grouped grid
// 16 bytes of weights (4 float32 or 8 bfloat16 values) as float32, in memory
// order (a bfloat16 value converted exactly).
__device__ __forceinline__ void ft_unpack(uint4 q, float (&w)[4]) {
  w[0] = __uint_as_float(q.x);
  w[1] = __uint_as_float(q.y);
  w[2] = __uint_as_float(q.z);
  w[3] = __uint_as_float(q.w);
}

__device__ __forceinline__ void ft_unpack(uint4 q, float (&w)[8]) {
  l2s_bf16x2(q.x, w[0], w[1]);
  l2s_bf16x2(q.y, w[2], w[3]);
  l2s_bf16x2(q.z, w[4], w[5]);
  l2s_bf16x2(q.w, w[6], w[7]);
}

// One step of the butterfly over the 2 * HALF sums a lane holds: the lane
// keeps half of them (the upper half where its lane bit `off` is set), sends
// the other half to its partner lane ^ off, and adds what the partner sends
// to the half it kept: each sum is its own plus the partner's, as in the
// butterfly over one value.
template <int HALF, int NV>
__device__ __forceinline__ void ft_fold(float (&v)[NV], int lane, int off) {
  const bool up = (lane & off) != 0;
#pragma unroll
  for (int e = 0; e < HALF; ++e) {
    const float send = up ? v[e] : v[HALF + e];
    const float keep = up ? v[HALF + e] : v[e];
    v[e] = keep + __shfl_xor_sync(0xffffffffu, send, off);
  }
}

__device__ __forceinline__ void ft_cp16(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void ft_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void ft_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Words of shared memory the warps' rings take: FT_RING steps of FT_WROWS
// rows x 32 lanes x 16 bytes a warp.
#define FT_RING_WORDS ((FT_THREADS / 32) * FT_RING * FT_WROWS * 32 * 4)

// A warp's share of a gathered tile part (wp: its R weight rows of d values,
// each a whole number of 16-byte chunks) against the G rows of h in h_s (row
// g at h_s + g * hs, float32; the rows past the block's n are zeros):
//   x[g * R + r] = W[r] . h[g] + b[r]          (for g < n)
// The warp takes weight rows [r0, r0 + M) for r0 = warp * M, + nwarps * M,
// ..., and walks each over d one 16-byte chunk a lane a step (chunks l,
// l+32, ... as l2s_warp_dot deals them to lanes): cp.async keeps the next
// FT_RING - 1 steps in flight into the warp's own ring in shared memory
// while it multiplies this step's chunks with all G rows of h (start()
// starts the first ones, which fly while the caller stages h). A lane copies
// and reads only its own slots. Each lane accumulates its chunks of every
// dot product with fmaf in ascending order, as l2s_warp_dot does; each chunk
// of h read from shared memory feeds M products, each chunk of W G, and no
// branch parts the rows of h, so their loads run ahead. At the end of a pass
// over a row the M x G sums over the lanes take the xor butterfly's own tree
// of additions, all at once (ft_fold: 64 sums cost 62 shuffles, not 320);
// lane l ends holding the sums 2l and 2l + 1.
template <typename T>
struct FtWarpLogits {
  static constexpr int M = FT_WROWS;
  static constexpr int G = FT_GROUP;
  static constexpr int CW = 16 / sizeof(T);  // values a chunk
  static constexpr int NV = M * G;
  static constexpr int NL = NV / 32;         // sums a lane ends with
  static_assert(NV % 32 == 0, "the butterfly hands each lane whole sums");
  const T* wp;
  uint4* ring;                               // this warp's FT_RING x M x 32 slots
  int d, nch, nb, R, lane, stride, r0w, steps;

  __device__ __forceinline__ void copy(int st) {
    if (st < steps) {
      const int r0 = r0w + (st / nb) * stride;
      const int c = (st % nb) * 32 + lane;
      if (c < nch) {
        uint4* slot = ring + (st % FT_RING) * M * 32 + lane;
#pragma unroll
        for (int m = 0; m < M; ++m)
          ft_cp16(slot + m * 32, reinterpret_cast<const uint4*>(wp + (size_t)(r0 + m) * d) + c);
      }
    }
    ft_cp_commit();                          // empty past the end: the count stays
  }

  __device__ __forceinline__ void start(const T* w_part, int d_, int R_, int lane_, int warp,
                                        int nwarps, uint4* ring_base) {
    wp = w_part;
    d = d_;
    nch = d_ * (int)sizeof(T) / 16;
    nb = (nch + 31) / 32;                    // steps a pass over a row
    R = R_;
    lane = lane_;
    stride = nwarps * M;
    r0w = warp * M;
    steps = r0w < R ? (R - r0w + stride - 1) / stride * nb : 0;
    ring = ring_base + warp * FT_RING * M * 32;
#pragma unroll
    for (int st = 0; st < FT_RING - 1; ++st) copy(st);
  }

  __device__ __forceinline__ void run(const T* __restrict__ bp, const float* __restrict__ h_s,
                                      int hs, int n, float* __restrict__ x) {
    float v[NV];
#pragma unroll
    for (int e = 0; e < NV; ++e) v[e] = 0.f;
    for (int st = 0, bi = 0, r0 = r0w; st < steps; ++st) {
      copy(st + FT_RING - 1);
      ft_cp_wait<FT_RING - 1>();             // this step's chunks have landed
      const int c = bi * 32 + lane;
      if (c < nch) {
        const uint4* slot = ring + (st % FT_RING) * M * 32 + lane;
        float w[M][CW];
#pragma unroll
        for (int m = 0; m < M; ++m) ft_unpack(slot[m * 32], w[m]);
        const float4* h4 = reinterpret_cast<const float4*>(h_s) + c * (CW / 4);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float xh[CW];
#pragma unroll
          for (int q = 0; q < CW / 4; ++q) {
            const float4 y = h4[g * (hs / 4) + q];
            xh[4 * q] = y.x;
            xh[4 * q + 1] = y.y;
            xh[4 * q + 2] = y.z;
            xh[4 * q + 3] = y.w;
          }
#pragma unroll
          for (int m = 0; m < M; ++m)
#pragma unroll
            for (int q = 0; q < CW; ++q) v[m * G + g] = fmaf(w[m][q], xh[q], v[m * G + g]);
        }
      }
      if (++bi == nb) {                      // a pass ends: the sums, then x
        ft_fold<NV / 2>(v, lane, 16);
        ft_fold<NV / 4>(v, lane, 8);
        ft_fold<NV / 8>(v, lane, 4);
        ft_fold<NV / 16>(v, lane, 2);
        ft_fold<NV / 32>(v, lane, 1);
#pragma unroll
        for (int s = 0; s < NL; ++s) {
          const int idx = lane * NL + s;
          const int m = idx / G, g = idx - m * G;
          if (g < n) x[g * R + r0 + m] = v[s] + l2s_load(bp + r0 + m);
        }
#pragma unroll
        for (int e = 0; e < NV; ++e) v[e] = 0.f;
        bi = 0;
        r0 += stride;
      }
    }
    ft_cp_wait<0>();
  }
};

// Stage rows rows[0..n) of h (B, d), rows whole numbers of 16-byte chunks,
// in shared memory as float32, row g at h_s + g * hs, and zeros in rows
// [n, FT_GROUP), with the whole block: FT_STAGE loads a thread in flight
// before any is stored.
#define FT_STAGE 4
__device__ __forceinline__ void ft_stage_chunk(const float*, float* dst, uint4 q) {
  *reinterpret_cast<uint4*>(dst) = q;
}
__device__ __forceinline__ void ft_stage_chunk(const __nv_bfloat16*, float* dst, uint4 q) {
  float w[8];
  ft_unpack(q, w);
  *reinterpret_cast<float4*>(dst) = make_float4(w[0], w[1], w[2], w[3]);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(w[4], w[5], w[6], w[7]);
}

template <typename T>
__device__ __forceinline__ void ft_stage_rows(const T* __restrict__ h, const int* rows, int n,
                                              int d, float* __restrict__ h_s, int hs) {
  constexpr int CW = 16 / sizeof(T);
  const int nt = blockDim.x, dc = d / CW, total = n * dc;
  for (int e = n * hs + threadIdx.x; e < FT_GROUP * hs; e += nt) h_s[e] = 0.f;
  for (int e0 = threadIdx.x; e0 < total; e0 += FT_STAGE * nt) {
    uint4 q[FT_STAGE];
    int at[FT_STAGE];
#pragma unroll
    for (int u = 0; u < FT_STAGE; ++u) {
      const int e = e0 + u * nt;
      if (e < total) {
        const int g = e / dc, c = e - g * dc;
        q[u] = __ldg(reinterpret_cast<const uint4*>(h + (size_t)rows[g] * d) + c);
        at[u] = g * hs + CW * c;
      }
    }
#pragma unroll
    for (int u = 0; u < FT_STAGE; ++u)
      if (e0 + u * nt < total) ft_stage_chunk(h, h_s + at[u], q[u]);
  }
}

// Block (part p, chunk c): chunks[c] = (n pairs, the tile), n = 0 past
// the last chunk; pairs[c * G + g] = row * K + slot for g < n, a (row, slot)
// whose candidate block is the tile (n_blk: a sentinel slot).
template <typename T>
__device__ __forceinline__ void fused_topk_grouped_body(
    const T* __restrict__ W, const T* __restrict__ b, const T* __restrict__ h,
    const int* __restrict__ ids, const float* __restrict__ noise,
    const int* __restrict__ pairs, const int2* __restrict__ chunks,
    float* __restrict__ part_v, int* __restrict__ part_p, float* __restrict__ part_m,
    float* __restrict__ part_s, unsigned* __restrict__ count, int* __restrict__ out_ids,
    float* __restrict__ out_vals, float* __restrict__ out_logz, int K, int n_blk, int d,
    int k, int P, int kk, int merges) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  __shared__ int rows_s[FT_GROUP];           // each pair's row
  __shared__ int slots_s[FT_GROUP];          // and slot
  __shared__ int last_s[FT_GROUP];           // the rows this block merges
  __shared__ int n_last;

  const int t = threadIdx.x;
  const int pr = t < FT_GROUP ? __ldg(pairs + (size_t)blockIdx.y * FT_GROUP + t) : 0;
  const int2 ch = chunks[blockIdx.y];
  const int n = ch.x;
  if (n <= 0) return;                        // past the last chunk: uniform
  const int blk = ch.y;
  const bool valid = blk < n_blk;
  const int R = L2S_V_BLK / P;
  const int L = K * P;
  const int p = blockIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nwarps = blockDim.x >> 5;
  const int hs = (d + 3) & ~3;
  float* h_s = sm;                           // G rows of h (rounded to float4)
  float* x = h_s + FT_GROUP * hs;            // G x R logits
  uint4* rings = reinterpret_cast<uint4*>(x + FT_GROUP * R);
  const size_t row0 = (size_t)blk * L2S_V_BLK + p * R;
  FtWarpLogits<T> wl;
  if (valid) wl.start(W + row0 * d, d, R, lane, warp, nwarps, rings);  // flies while h is staged
  if (t < n) {
    rows_s[t] = pr / K;
    slots_s[t] = pr - (pr / K) * K;
  }
  if (t == 0) n_last = 0;
  __syncthreads();

  // ---- phase A for the chunk's n (row, slot) pairs
  if (valid) {                               // uniform over the block
    ft_stage_rows(h, rows_s, n, d, h_s, hs);
    __syncthreads();
    wl.run(b + row0, h_s, hs, n, x);
    __syncthreads();
    // each pair's part by one warp: (max, sum-exp) of the raw logits, then
    // the noise; short lists by kk rounds of a warp argmax, long ones below
    for (int g = warp; g < n; g += nwarps) {
      float* xg = x + g * R;
      const int i = rows_s[g], j = slots_s[g];
      const size_t q = (size_t)i * L + j * P + p;
      float m, s;
      ft_part_pair(xg, R, lane, m, s);
      if (lane == 0) {
        part_m[q] = m;
        part_s[q] = s;
      }
      if (noise) {
        const float* ng = noise + ((size_t)i * K + j) * L2S_V_BLK + p * R;
        for (int r = lane; r < R; r += 32) xg[r] = xg[r] + __ldg(ng + r);
        __syncwarp();
      }
      if (kk <= FT_SELECT)
        ft_select(xg, R, kk, j * L2S_V_BLK + p * R, lane, part_v + q * kk, part_p + q * kk);
    }
    if (kk > FT_SELECT) {
      __syncthreads();
      for (int e = t; e < n * R; e += blockDim.x) {
        const int g = e / R, r = e - g * R;
        const float* xg = x + g * R;
        const float v = xg[r];
        int rank = 0;
        for (int u = 0; u < R; ++u) rank += ft_before(xg[u], u, v, r);
        if (rank < kk) {
          const size_t q = (size_t)rows_s[g] * L + slots_s[g] * P + p;
          part_v[q * kk + rank] = v;
          part_p[q * kk + rank] = slots_s[g] * L2S_V_BLK + p * R + r;
        }
      }
    }
  } else {
    for (int e = t; e < n * kk; e += blockDim.x) {
      const int g = e / kk, r = e - g * kk;
      const size_t q = (size_t)rows_s[g] * L + slots_s[g] * P + p;
      part_v[q * kk + r] = L2S_NEG_INF;
      part_p[q * kk + r] = slots_s[g] * L2S_V_BLK + p * R + r;
    }
    if (t < n) {
      const size_t q = (size_t)rows_s[t] * L + slots_s[t] * P + p;
      part_m[q] = -INFINITY;
      part_s[q] = 0.f;
    }
  }

  // ---- each row's last block merges it; this block may be last for several
  __threadfence();
  __syncthreads();
  if (t < n) {
    const int i = rows_s[t];
    if (atomicAdd(count + i, 1u) == (unsigned)(L - 1)) {
      count[i] = 0u;                         // every block of the row has counted
      last_s[atomicAdd(&n_last, 1)] = i;
    }
  }
  __syncthreads();
  const int nl = n_last;
  if (nl == 0) return;
  __threadfence();
  const int pair = warp >> 1;                // a pair of warps merges a row
  float* s = sm + (size_t)pair * 5 * L;
  for (int base = 0; base < nl; base += merges) {
    const bool mine = pair < merges && base + pair < nl;
    const int i = mine ? last_s[base + pair] : 0;
    if (mine) ft_merge_load(i, L, kk, part_v, part_p, part_m, part_s, s, t & 63, 64);
    __syncthreads();
    if (mine) {
      if (warp & 1)
        ft_merge_logz(i, L, s, lane, out_logz);
      else
        ft_merge_topk(i, L, kk, k, K, n_blk, ids, part_v, part_p, s, lane, out_ids,
                      out_vals);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(FT_THREADS)
fused_topk_kernel(const float* __restrict__ W, const float* __restrict__ b,
                  const float* __restrict__ h, const int* __restrict__ ids,
                  const float* __restrict__ noise, float* __restrict__ part_v,
                  int* __restrict__ part_p, float* __restrict__ part_m,
                  float* __restrict__ part_s, unsigned* __restrict__ count,
                  int* __restrict__ out_ids, float* __restrict__ out_vals,
                  float* __restrict__ out_logz, int K, int n_blk, int d, int k,
                  int P, int kk) {
  fused_topk_body(W, b, h, ids, noise, part_v, part_p, part_m, part_s, count, out_ids,
                  out_vals, out_logz, K, n_blk, d, k, P, kk);
}

__global__ void __launch_bounds__(FT_THREADS)
fused_topk_bf16_kernel(const __nv_bfloat16* __restrict__ W,
                       const __nv_bfloat16* __restrict__ b,
                       const __nv_bfloat16* __restrict__ h, const int* __restrict__ ids,
                       const float* __restrict__ noise, float* __restrict__ part_v,
                       int* __restrict__ part_p, float* __restrict__ part_m,
                       float* __restrict__ part_s, unsigned* __restrict__ count,
                       int* __restrict__ out_ids, float* __restrict__ out_vals,
                       float* __restrict__ out_logz, int K, int n_blk, int d, int k,
                       int P, int kk) {
  fused_topk_body(W, b, h, ids, noise, part_v, part_p, part_m, part_s, count, out_ids,
                  out_vals, out_logz, K, n_blk, d, k, P, kk);
}

// The grouped twins; their names begin with the per-row kernels' (a profile
// counts both under the kernel's name). Two blocks an SM: at most 128
// registers a thread.
__global__ void __launch_bounds__(FT_THREADS, 2)
fused_topk_kernel_grouped(const float* __restrict__ W, const float* __restrict__ b,
                          const float* __restrict__ h, const int* __restrict__ ids,
                          const float* __restrict__ noise, const int* __restrict__ pairs,
                          const int2* __restrict__ chunks, float* __restrict__ part_v,
                          int* __restrict__ part_p, float* __restrict__ part_m,
                          float* __restrict__ part_s, unsigned* __restrict__ count,
                          int* __restrict__ out_ids, float* __restrict__ out_vals,
                          float* __restrict__ out_logz, int K, int n_blk, int d, int k,
                          int P, int kk, int merges) {
  fused_topk_grouped_body(W, b, h, ids, noise, pairs, chunks, part_v, part_p, part_m,
                          part_s, count, out_ids, out_vals, out_logz, K, n_blk, d, k, P, kk,
                          merges);
}

__global__ void __launch_bounds__(FT_THREADS, 2)
fused_topk_bf16_kernel_grouped(const __nv_bfloat16* __restrict__ W,
                               const __nv_bfloat16* __restrict__ b,
                               const __nv_bfloat16* __restrict__ h,
                               const int* __restrict__ ids, const float* __restrict__ noise,
                               const int* __restrict__ pairs,
                               const int2* __restrict__ chunks, float* __restrict__ part_v,
                               int* __restrict__ part_p, float* __restrict__ part_m,
                               float* __restrict__ part_s, unsigned* __restrict__ count,
                               int* __restrict__ out_ids, float* __restrict__ out_vals,
                               float* __restrict__ out_logz, int K, int n_blk, int d,
                               int k, int P, int kk, int merges) {
  fused_topk_grouped_body(W, b, h, ids, noise, pairs, chunks, part_v, part_p, part_m,
                          part_s, count, out_ids, out_vals, out_logz, K, n_blk, d, k, P, kk,
                          merges);
}

// ---- grouping the (row, slot) pairs by tile, through the clusters: one block,
// every step parallel over rows, clusters, tiles or pairs.
//   1. each row takes a place among its cluster's rows (an atomic on the
//      cluster's count: the order within a cluster is the arrivals', which
//      nothing downstream depends on; the plain version sorts stably);
//   2. each (cluster, slot) adds the cluster's rows to its tile's count (a
//      sentinel slot counts under tile n_blk);
//   3. warp 0 scans the tiles' counts: each tile's first chunk (ceil(count /
//      G) chunks a tile) and the chunk table: chunk c = (pairs, tile), zeros
//      past the last real chunk, up to n_chunks;
//   4. each (cluster, slot) takes a run of its tile's places, and each (row,
//      slot) writes its pair at its cluster's run, at the row's place: the
//      p-th pair of a tile whose first chunk is f lands at pairs[f * G + p],
//      chunk f + p / G's slot p % G.
// A cluster id outside [0, r) counts as the nearest of 0 and r - 1.
__global__ void __launch_bounds__(GR_THREADS)
group_rows_kernel(const int* __restrict__ cluster, const int* __restrict__ cand,
                  int* __restrict__ pairs, int2* __restrict__ chunks, int B, int r, int K,
                  int n_blk, int n_chunks) {
  extern __shared__ int gsm[];
  const int T = n_blk + 1;                   // tiles, the sentinel last
  int* hist = gsm;                           // r: rows of each cluster
  int* thist = hist + r;                     // T: pairs of each tile
  int* tcursor = thist + T;                  // T: its next place in pairs
  int* run = tcursor + T;                    // r K: each (cluster, slot)'s first place
  int* cl = run + r * K;                     // B: each row's cluster
  int* place = cl + B;                       // B: its place among the cluster's rows
  __shared__ int n_real;
  const int t = threadIdx.x;
  for (int c = t; c < r; c += blockDim.x) hist[c] = 0;
  for (int c = t; c < T; c += blockDim.x) thist[c] = 0;
  __syncthreads();
  for (int i = t; i < B; i += blockDim.x) {
    const int c = min(max(__ldg(cluster + i), 0), r - 1);
    cl[i] = c;
    place[i] = atomicAdd(hist + c, 1);
  }
  __syncthreads();
  for (int e = t; e < r * K; e += blockDim.x) {
    const int nr = hist[e / K];
    if (nr) {
      const int tile = __ldg(cand + e);
      atomicAdd(thist + (tile >= 0 && tile < n_blk ? tile : n_blk), nr);
    }
  }
  __syncthreads();
  if (t < 32) {                              // warp 0 scans the tiles
    int before = 0;
    for (int c0 = 0; c0 < T; c0 += 32) {
      const int c = c0 + t;
      const int v = c < T ? (thist[c] + FT_GROUP - 1) / FT_GROUP : 0;
      int x = v;                             // an inclusive scan over the warp
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, off);
        if (t >= off) x += y;
      }
      if (c < T) {
        const int first = before + x - v;
        tcursor[c] = first * FT_GROUP;
        for (int q = 0; q < v; ++q)
          chunks[first + q] = make_int2(min(FT_GROUP, thist[c] - q * FT_GROUP), c);
      }
      before += __shfl_sync(0xffffffffu, x, 31);
    }
    if (t == 0) n_real = before;
  }
  __syncthreads();
  for (int c = n_real + t; c < n_chunks; c += blockDim.x) chunks[c] = make_int2(0, 0);
  for (int e = t; e < r * K; e += blockDim.x) {  // each (cluster, slot) its run
    const int nr = hist[e / K];
    if (nr) {
      const int tile = __ldg(cand + e);
      run[e] = atomicAdd(tcursor + (tile >= 0 && tile < n_blk ? tile : n_blk), nr);
    }
  }
  __syncthreads();
  for (int e = t; e < B * K; e += blockDim.x) {  // (row, slot)
    const int i = e / K, j = e - i * K;
    pairs[run[cl[i] * K + j] + place[i]] = e;
  }
}

template <typename T, typename Kernel>
static int fused_topk_launch(Kernel kernel, const T* W, const T* b, const T* h,
                             const int* ids, const float* noise, int* out_ids,
                             float* out_vals, float* out_logz, void* scratch,
                             unsigned* count, int B, int K, int n_blk, int d, int k,
                             int P, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (K <= 0 || k <= 0 || P <= 0 || P > 8 || L2S_V_BLK % P || B > 65535 ||
      (long)k > (long)K * L2S_V_BLK)
    return (int)cudaErrorInvalidValue;
  const int R = L2S_V_BLK / P;
  const int kk = k < R ? k : R;
  const size_t parts = (size_t)B * K * P;
  float* part_v = reinterpret_cast<float*>(scratch);
  int* part_p = reinterpret_cast<int*>(part_v + parts * kk);
  float* part_m = reinterpret_cast<float*>(part_p + parts * kk);
  float* part_s = part_m + parts;
  // phase A: h (d, rounded to float4) and R logits; phase B: a head, its
  // value and position, a max and a sum per list
  const size_t words_a = (size_t)((d + 3) & ~3) + R;
  const size_t words_b = 5 * (size_t)K * P;
  const size_t smem = (words_a > words_b ? words_a : words_b) * sizeof(float);
  if (smem > FT_SMEM_OPTIN) return (int)cudaErrorInvalidValue;
  cudaError_t err = l2s_allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(K * P, B), FT_THREADS, smem, (cudaStream_t)stream>>>(
      W, b, h, ids, noise, part_v, part_p, part_m, part_s, count, out_ids, out_vals,
      out_logz, K, n_blk, d, k, P, kk);
  return (int)cudaGetLastError();
}

template <typename T, typename Kernel>
static int fused_topk_grouped_launch(Kernel kernel, const T* W, const T* b, const T* h,
                                     const int* ids, const float* noise, const int* pairs,
                                     const void* chunks, int* out_ids, float* out_vals,
                                     float* out_logz, void* scratch, unsigned* count,
                                     int B, int K, int n_blk, int d, int k, int P,
                                     int n_chunks, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (K <= 0 || k <= 0 || P <= 0 || P > 8 || L2S_V_BLK % P || B > 65535 ||
      n_chunks <= 0 || n_chunks > 65535 || (long)k > (long)K * L2S_V_BLK ||
      (d * sizeof(T)) % 16)
    return (int)cudaErrorInvalidValue;
  const int R = L2S_V_BLK / P;
  const int kk = k < R ? k : R;
  const size_t parts = (size_t)B * K * P;
  float* part_v = reinterpret_cast<float*>(scratch);
  int* part_p = reinterpret_cast<int*>(part_v + parts * kk);
  float* part_m = reinterpret_cast<float*>(part_p + parts * kk);
  float* part_s = part_m + parts;
  // phase A: G rows of h (d, rounded to float4), G x R logits and the
  // warps' rings; phase B: 5 words a list of a row, for as many rows at once
  // (up to FT_MERGE_PAIRS) as fit in phase A's memory, one at least
  const size_t words_a =
      (size_t)FT_GROUP * (((d + 3) & ~3) + R) + FT_RING_WORDS;
  const size_t words_row = 5 * (size_t)K * P;
  size_t merges = words_a / words_row;
  merges = merges < 1 ? 1 : merges > FT_MERGE_PAIRS ? FT_MERGE_PAIRS : merges;
  const size_t words_b = merges * words_row;
  const size_t smem = (words_a > words_b ? words_a : words_b) * sizeof(float);
  if (smem > FT_SMEM_OPTIN) return (int)cudaErrorInvalidValue;
  cudaError_t err = l2s_allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(P, n_chunks), FT_THREADS, smem, (cudaStream_t)stream>>>(
      W, b, h, ids, noise, pairs, static_cast<const int2*>(chunks), part_v, part_p, part_m,
      part_s, count, out_ids, out_vals, out_logz, K, n_blk, d, k, P, kk, (int)merges);
  return (int)cudaGetLastError();
}

// W (n_blk, 128, d) f32, b (n_blk, 128) f32, h (B, d) f32, ids (B, K) int32,
// noise (B, K, 128) f32 or null; out_ids (B, k) int32, out_vals (B, k) f32,
// out_logz (B,) f32; 1 <= k <= K*128; scratch: B*K*P*(2*kk + 2) words,
// kk = min(k, 128 / P); count: B uint32 counters, zero on entry and left
// zero; P in {1, 2, 4, 8}, K*P <= 11,622. All contiguous on one device, W and
// h 16-byte aligned. Returns a cudaError_t (0 on success).
extern "C" int l2s_fused_screened_topk(const float* W, const float* b, const float* h,
                                       const int* ids, const float* noise,
                                       int* out_ids, float* out_vals, float* out_logz,
                                       void* scratch, unsigned* count, int B, int K,
                                       int n_blk, int d, int k, int P, void* stream) {
  return fused_topk_launch(fused_topk_kernel, W, b, h, ids, noise, out_ids, out_vals,
                           out_logz, scratch, count, B, K, n_blk, d, k, P, stream);
}

// The same with W, b and h in bfloat16 (noise and the outputs stay float32).
extern "C" int l2s_fused_screened_topk_bf16(const void* W, const void* b, const void* h,
                                            const int* ids, const float* noise,
                                            int* out_ids, float* out_vals,
                                            float* out_logz, void* scratch,
                                            unsigned* count, int B, int K, int n_blk,
                                            int d, int k, int P, void* stream) {
  return fused_topk_launch(
      fused_topk_bf16_kernel, static_cast<const __nv_bfloat16*>(W),
      static_cast<const __nv_bfloat16*>(b), static_cast<const __nv_bfloat16*>(h), ids,
      noise, out_ids, out_vals, out_logz, scratch, count, B, K, n_blk, d, k, P, stream);
}

// cluster (B,) int32 in [0, r), cand (r, K) int32 (each cluster's candidate
// blocks, sentinel outside [0, n_blk)) → chunks (n_chunks, 2) int32, each
// tile's (row, slot) pairs cut into runs of up to FT_GROUP, tile by tile (the
// sentinel last): (pairs, tile), zeros past the last; pairs (n_chunks *
// FT_GROUP,) int32, chunk c's pairs row * K + slot at [c * FT_GROUP, c *
// FT_GROUP + pairs). n_chunks >= ceil(B K / FT_GROUP) + min(n_blk + 1, B K),
// the most any routes need.
extern "C" int l2s_group_rows(const int* cluster, const int* cand, int* pairs, void* chunks,
                              int B, int r, int K, int n_blk, int n_chunks, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  const long bk = (long)B * K;
  if (r <= 0 || K <= 0 || n_blk <= 0 ||
      (long)n_chunks < (bk + FT_GROUP - 1) / FT_GROUP + (n_blk + 1L < bk ? n_blk + 1L : bk))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      ((1 + (size_t)K) * r + 2 * ((size_t)n_blk + 1) + 2 * (size_t)B) * sizeof(int);
  if (smem > FT_SMEM_OPTIN) return (int)cudaErrorInvalidValue;
  cudaError_t err = l2s_allow_smem(group_rows_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  group_rows_kernel<<<1, GR_THREADS, smem, (cudaStream_t)stream>>>(
      cluster, cand, pairs, static_cast<int2*>(chunks), B, r, K, n_blk, n_chunks);
  return (int)cudaGetLastError();
}

// The grouped grid: the arguments of l2s_fused_screened_topk, with pairs and
// chunks from l2s_group_rows over the routes and candidates that gave ids,
// and the chunk table's length. Same scratch, counters and results. Rows of
// W and h are whole numbers of 16-byte chunks.
extern "C" int l2s_fused_screened_topk_grouped(const float* W, const float* b,
                                               const float* h, const int* ids,
                                               const float* noise, const int* pairs,
                                               const void* chunks, int* out_ids,
                                               float* out_vals, float* out_logz,
                                               void* scratch, unsigned* count, int B,
                                               int K, int n_blk, int d, int k, int P,
                                               int n_chunks, void* stream) {
  return fused_topk_grouped_launch(fused_topk_kernel_grouped, W, b, h, ids, noise, pairs,
                                   chunks, out_ids, out_vals, out_logz, scratch, count, B,
                                   K, n_blk, d, k, P, n_chunks, stream);
}

extern "C" int l2s_fused_screened_topk_grouped_bf16(
    const void* W, const void* b, const void* h, const int* ids, const float* noise,
    const int* pairs, const void* chunks, int* out_ids, float* out_vals, float* out_logz,
    void* scratch, unsigned* count, int B, int K, int n_blk, int d, int k, int P,
    int n_chunks, void* stream) {
  return fused_topk_grouped_launch(
      fused_topk_bf16_kernel_grouped, static_cast<const __nv_bfloat16*>(W),
      static_cast<const __nv_bfloat16*>(b), static_cast<const __nv_bfloat16*>(h), ids,
      noise, pairs, chunks, out_ids, out_vals, out_logz, scratch, count, B, K, n_blk, d, k,
      P, n_chunks, stream);
}
