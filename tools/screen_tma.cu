// An alternative design of src/repro_torch/csrc/screen.cu's kernel, kept as
// the reference input of tools/screen_ab.py; the port does not build it.
// Under the same clean-L2 timer it is slower than the split grid the port
// runs at every decode shape (PERF.md, section 6).
//
// screened_logits: the raw logits of every routed candidate tile,
//   out[i, j, :] = W_blocks[block_ids[i, j]] . h[i] + b_blocks[block_ids[i, j]]
//
// Replaces the Pallas kernel src/repro/kernels/screen.py::screened_logits
// (_screened_logits_kernel, pl.pallas_call at screen.py:68), whose scalar
// prefetch chooses which (128, d) tile of W each (row, slot) program DMAs.
// As there, a sentinel id (outside [0, n_blk)) reads tile 0 and its output is
// left unmasked: the caller (kernels/ops.py) masks it.
//
// Bound on the H100: bytes. The call must read each DISTINCT tile among the
// B*K ids once (128 x d floats, 256,000 bytes at d = 500), for 2 flops per
// weight and pair holding the tile, and write B*K*128 floats.
//
// Design: grid (K*P, B), 32 * (SCR_CONSUMERS + 1) threads, one block per
// (row i, slot j, part p of the tile); nothing is sorted, no host sync.
// - Owner rule. Pair (i, j) at flattened position f = i*K + j holds tile
//   t = ids[i, j] (tile 0 for a sentinel). The holders of t are split, in
//   flattened order, into groups of M; the block of a group's first holder
//   owns it: it writes the logits of the group's M pairs, and every other
//   block exits after counting the holders before it (one count per 288
//   ids). A tile with at most M holders is read from device memory once,
//   whatever L2 holds: the random decode screen reads each of its distinct
//   tiles once (41 of 64 at d = 500), the full-cover screen 196 of 800, a
//   beam whose 5 hypotheses share a cluster one in five. Groups beyond the
//   first read the tile again, from L2 as a rule; they spread a tile held
//   by many pairs (tile 0 under all of a screen's sentinel slots) over
//   several blocks, where one owner would run dozens of dot products in a
//   row.
// - M is as many h rows as fit in SCR_H_BYTES of shared memory (8 at
//   d = 500, 3 at d = 2560), so shared memory does not grow with B*K. Once
//   the group is known, lane 0 of the producer warp bulk-copies its h rows
//   into shared memory on their own mbarrier (a ragged d, whose rows are not
//   16-byte multiples: plain loads by the consumer threads).
// - Parts. Block p owns rows [p*R, (p+1)*R) of the tile, R = 128 / P, one
//   contiguous R*d-float slab. l2s_screened_parts picks P.
// - Ring. Right after the owner check, lane 0 of the producer warp copies
//   the slab into a ring of S stages in shared memory with 1-D TMA bulk
//   copies (cp.async.bulk, completion counted in bytes on a "full" mbarrier
//   per stage); the consumers free a stage with one arrival per row on its
//   "empty" mbarrier. A copy is CR rows, the most (a power of two, 4 to R)
//   within SCR_CHUNK_BYTES: a multiple of 16 bytes and 16-byte aligned for
//   any d, and as large as fits, since one block's stream of bulk copies on
//   this card runs faster the larger each copy is.
// - Consumers. Row r goes to consumer warp r % SCR_CONSUMERS. A warp reads
//   the staged row once per pass over up to 4 owned pairs, whose sums are
//   independent chains (scr_dots<4>, <2>, <1>), and stores their logits.
//   With CR = 4 a chunk's rows go to 4 of the 8 warps, and S is even, so the
//   warps that wait on a stage's phase n have waited on its phase n - 1, as
//   a parity wait needs; with CR >= 8 every warp has rows in every chunk.
// - Summation order: l2s_warp_dot's (l2s_common.cuh). Lane l accumulates the
//   float4 chunks l, l+32, ... of the row in ascending order with fmaf in x,
//   y, z, w order (a ragged d: the single floats l, l+32, ...), an xor
//   butterfly 16, 8, 4, 2, 1 sums the lanes, and the bias is added last. So
//   these logits are bit-identical to fused_topk.cu's, which reads its rows
//   through registers, and do not depend on P or M.
// Limits: B <= 65535 (grid y); two 4-row stages and an h row must fit in a
// block's 227 KB (d <= 6,400); larger inputs are refused with
// cudaErrorInvalidValue.
#include <stdint.h>

#include "l2s_common.cuh"

#define SCR_CONSUMERS 8                         // consumer warps
#define SCR_THREADS (32 * (SCR_CONSUMERS + 1))  // and one producer warp
#define SCR_CHUNK_BYTES (32 * 1024)             // bulk copy target (at least 4 rows)
#define SCR_MAX_STAGES 8
#define SCR_RING_BYTES (64 * 1024)              // ring target (at least one copy)
#define SCR_MAX_PAIRS 8                         // pairs one block dots a tile with
#define SCR_H_BYTES (32 * 1024)                 // shared memory for their h rows
#define SCR_GRID_PER_SM 64                      // blocks an SM, at most, for P > 1

__device__ __forceinline__ uint32_t scr_smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Spin until the mbarrier at `bar` has completed the phase of parity `parity`.
__device__ __forceinline__ void scr_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ int scr_tile(int id, int n_blk) {
  return id >= 0 && id < n_blk ? id : 0;  // sentinel: tile 0, masked by the caller
}

// Chunk c (CR rows of d floats) of the slab into ring slot c % S: wait until
// the chunk S before it has been released, then one bulk copy.
__device__ __forceinline__ void scr_issue(const float* slab, float* ring,
                                          uint64_t* full, uint64_t* empty,
                                          int c, int S, int CR, int d) {
  const int s = c % S;
  const int round = c / S;
  const uint32_t bytes = (uint32_t)CR * d * sizeof(float);
  if (round > 0) scr_wait(scr_smem(empty + s), (round - 1) & 1);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(scr_smem(full + s)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(scr_smem(ring + (size_t)s * CR * d)),
         "l"(slab + (size_t)c * CR * d), "r"(bytes), "r"(scr_smem(full + s))
      : "memory");
}

// Dot products of a row staged in shared memory with NQ rows of h staged
// there too, by one warp, each in l2s_warp_dot's order: lane l
// sums the float4 chunks l, l+32, ... (a ragged d: the floats l, l+32, ...)
// in ascending order with fmaf in x, y, z, w order; an xor butterfly 16, 8,
// 4, 2, 1 leaves each sum in every lane. The NQ sums are independent chains,
// so a warp keeps NQ FMAs and 2 * NQ loads in flight.
template <int NQ>
__device__ __forceinline__ void scr_dots(const float* row, const float* const (&hr)[NQ],
                                         int d, int lane, float (&acc)[NQ]) {
#pragma unroll
  for (int q = 0; q < NQ; ++q) acc[q] = 0.f;
  if ((d & 3) == 0) {
    const float4* row4 = reinterpret_cast<const float4*>(row);
    const int d4 = d >> 2;
    int c = lane;
    for (; c + 32 < d4; c += 64) {             // two chunks per lane per step
      const float4 w0 = row4[c], w1 = row4[c + 32];
      float4 x0[NQ], x1[NQ];
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        x0[q] = reinterpret_cast<const float4*>(hr[q])[c];
        x1[q] = reinterpret_cast<const float4*>(hr[q])[c + 32];
      }
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        acc[q] = fmaf(w0.x, x0[q].x, acc[q]);
        acc[q] = fmaf(w0.y, x0[q].y, acc[q]);
        acc[q] = fmaf(w0.z, x0[q].z, acc[q]);
        acc[q] = fmaf(w0.w, x0[q].w, acc[q]);
        acc[q] = fmaf(w1.x, x1[q].x, acc[q]);
        acc[q] = fmaf(w1.y, x1[q].y, acc[q]);
        acc[q] = fmaf(w1.z, x1[q].z, acc[q]);
        acc[q] = fmaf(w1.w, x1[q].w, acc[q]);
      }
    }
    if (c < d4) {
      const float4 w0 = row4[c];
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const float4 x = reinterpret_cast<const float4*>(hr[q])[c];
        acc[q] = fmaf(w0.x, x.x, acc[q]);
        acc[q] = fmaf(w0.y, x.y, acc[q]);
        acc[q] = fmaf(w0.z, x.z, acc[q]);
        acc[q] = fmaf(w0.w, x.w, acc[q]);
      }
    }
  } else {
    for (int c = lane; c < d; c += 32) {
      const float w = row[c];
#pragma unroll
      for (int q = 0; q < NQ; ++q) acc[q] = fmaf(w, hr[q][c], acc[q]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) acc[q] += __shfl_xor_sync(0xffffffffu, acc[q], off);
  }
}

// The logits of one staged row for the owned pairs [q0, q0 + NQ), whose h
// rows are staged at h_s + q * dp.
template <int NQ>
__device__ __forceinline__ void scr_row(const float* row, const float* h_s, int dp,
                                        const int* pos_s, int q0, int d, int lane,
                                        float bias, float* __restrict__ out_row) {
  const float* hr[NQ];
  int pos[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    pos[q] = pos_s[q0 + q];
    hr[q] = h_s + (size_t)(q0 + q) * dp;
  }
  float acc[NQ];
  scr_dots<NQ>(row, hr, d, lane, acc);
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) out_row[(size_t)pos[q] * L2S_V_BLK] = acc[q] + bias;
  }
}

__global__ void __launch_bounds__(SCR_THREADS, 4)
screened_logits_kernel(const float* __restrict__ W, const float* __restrict__ b,
                       const float* __restrict__ h, const int* __restrict__ ids,
                       float* __restrict__ out, int K, int n_blk, int d, int P,
                       int CR, int S, int M) {
  extern __shared__ float4 smem4[];
  __shared__ __align__(8) uint64_t full[SCR_MAX_STAGES];
  __shared__ __align__(8) uint64_t empty[SCR_MAX_STAGES];
  __shared__ __align__(8) uint64_t h_full;      // the group's h rows have landed
  __shared__ int pos_s[SCR_MAX_PAIRS];          // the owned pairs' flat positions
  __shared__ int warp_hits[SCR_THREADS / 32];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int R = L2S_V_BLK / P;
  const int BK = gridDim.y * K;
  const int j = blockIdx.x / P;
  const int p = blockIdx.x - j * P;
  const int f = blockIdx.y * K + j;
  const int tile = scr_tile(__ldg(ids + f), n_blk);
  // owner rule: f must be the first of a group of M holders of the tile
  // (its rank among the positions holding the tile a multiple of M)
  int rank = 0;
  for (int base = 0; base < f; base += SCR_THREADS) {
    const int e = base + t;
    rank += __syncthreads_count(e < f && scr_tile(__ldg(ids + e), n_blk) == tile);
  }
  if (rank % M) return;

  const int dp = (d + 3) & ~3;
  float* ring = reinterpret_cast<float*>(smem4);          // S x CR rows of d
  float* h_s = ring + (size_t)S * CR * d;                  // M h rows of dp
  float* bias_s = h_s + (size_t)M * dp;                    // R biases
  const size_t row0 = (size_t)tile * L2S_V_BLK + (size_t)p * R;
  const float* slab = W + row0 * d;
  const int n_chunks = R / CR;
  const int first = S < n_chunks ? S : n_chunks;
  const bool producer = warp == SCR_CONSUMERS;
  if (producer && lane == 0) {  // the first S copies fly while the pairs are collected
    for (int s = 0; s < S; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(scr_smem(full + s)) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                   :: "r"(scr_smem(empty + s)), "r"(CR) : "memory");
    }
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                 :: "r"(scr_smem(&h_full)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int c = 0; c < first; ++c) scr_issue(slab, ring, full, empty, c, S, CR, d);
  }
  for (int r = t; r < R; r += SCR_THREADS) bias_s[r] = __ldg(b + row0 + r);

  // the group: the first M positions >= f holding the tile, in order
  int n = 0;
  for (int base = f; base < BK && n < M; base += SCR_THREADS) {
    const int e = base + t;
    const bool hit = e < BK && scr_tile(__ldg(ids + e), n_blk) == tile;
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_hits[warp] = __popc(mask);
    __syncthreads();
    int r = n + __popc(mask & ((1u << lane) - 1u));
    int total = n;
    for (int w = 0; w < SCR_THREADS / 32; ++w) {
      r += w < warp ? warp_hits[w] : 0;
      total += warp_hits[w];
    }
    if (hit && r < M) pos_s[r] = e;
    __syncthreads();   // warp_hits read before the next round rewrites it
    n = total < M ? total : M;
  }

  // the group's h rows into h_s: bulk copies on h_full when rows are
  // 16-byte multiples, else plain loads by the consumer threads
  const bool h_bulk = (d & 3) == 0;
  if (h_bulk && producer && lane == 0) {
    const uint32_t h_bytes = (uint32_t)d * sizeof(float);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(scr_smem(&h_full)), "r"(h_bytes * n) : "memory");
    for (int q = 0; q < n; ++q)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];"
          :: "r"(scr_smem(h_s + (size_t)q * dp)), "l"(h + (size_t)(pos_s[q] / K) * d),
             "r"(h_bytes), "r"(scr_smem(&h_full))
          : "memory");
  } else if (!h_bulk && !producer) {
    for (int x = t; x < n * d; x += SCR_CONSUMERS * 32) {
      const int q = x / d;
      h_s[(size_t)q * dp + (x - q * d)] = __ldg(h + (size_t)(pos_s[q] / K) * d + (x - q * d));
    }
  }
  __syncthreads();     // barriers, biases, pos_s (and a ragged h_s) are ready

  if (producer) {
    if (lane == 0)
      for (int c = first; c < n_chunks; ++c) scr_issue(slab, ring, full, empty, c, S, CR, d);
    return;
  }
  // row r of the slab to consumer warp r % SCR_CONSUMERS: its logit for every
  // owned pair, then one arrival on its stage's empty barrier
  for (int r = warp; r < R; r += SCR_CONSUMERS) {
    const int c = r / CR;
    const int s = c % S;
    const float* row = ring + ((size_t)s * CR + (r & (CR - 1))) * d;
    const float bias = bias_s[r];
    float* out_row = out + (size_t)p * R + r;
    if (h_bulk && r == warp) scr_wait(scr_smem(&h_full), 0);
    scr_wait(scr_smem(full + s), (c / S) & 1);
    int q = 0;
    for (; q + 4 <= n; q += 4) scr_row<4>(row, h_s, dp, pos_s, q, d, lane, bias, out_row);
    if (q + 2 <= n) {
      scr_row<2>(row, h_s, dp, pos_s, q, d, lane, bias, out_row);
      q += 2;
    }
    if (q < n) scr_row<1>(row, h_s, dp, pos_s, q, d, lane, bias, out_row);
    __syncwarp();
    if (lane == 0)
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                   :: "r"(scr_smem(empty + s)) : "memory");
  }
}

// Parts per tile: 8, halved while the grid (owners and exiting blocks
// alike) would exceed SCR_GRID_PER_SM blocks an SM. The owners are not known
// on the host without a sync; every block pays one scan of the ids and a
// slot, so the rule counts all B*K*P of them. chip_smoke.py times P = 1, 2,
// 4, 8 at the decode, beam and full-cover shapes (PERF.md).
extern "C" int l2s_screened_parts(int B, int K, int n_sm) {
  int parts = 8;
  while (parts > 1 && (long)B * K * parts > (long)SCR_GRID_PER_SM * n_sm) parts /= 2;
  return parts;
}

// W (n_blk, 128, d) f32, b (n_blk, 128) f32, h (B, d) f32, ids (B, K) int32,
// out (B, K, 128) f32; all contiguous on one device, W and h 16-byte aligned;
// P in {1, 2, 4, 8}, or 0 for l2s_screened_parts' choice on the current
// device. Returns a cudaError_t (0 on success).
extern "C" int l2s_screened_logits(const float* W, const float* b, const float* h,
                                         const int* ids, float* out, int B, int K,
                                         int n_blk, int d, int P, void* stream) {
  if (B <= 0 || K <= 0) return (int)cudaSuccess;
  cudaError_t err;
  if (P == 0) {
    int dev, n_sm;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    P = l2s_screened_parts(B, K, n_sm);
  }
  if (P < 1 || P > 8 || L2S_V_BLK % P || B > 65535 || d <= 0 || n_blk <= 0)
    return (int)cudaErrorInvalidValue;
  const int R = L2S_V_BLK / P;
  // rows per bulk copy: the most (a power of two, 4 to R) within
  // SCR_CHUNK_BYTES, as a copy's rate grows with its size
  int CR = 4;
  while (CR < R && (size_t)2 * CR * d * sizeof(float) <= SCR_CHUNK_BYTES) CR *= 2;
  const int n_chunks = R / CR;
  const size_t chunk = (size_t)CR * d * sizeof(float);
  int S = (int)(SCR_RING_BYTES / chunk);
  S = S < 1 ? 1 : S;
  S = S > n_chunks ? n_chunks : S;
  S = S > SCR_MAX_STAGES ? SCR_MAX_STAGES : S;
  // with CR = 4 a chunk's rows go to 4 of the 8 consumer warps, chunk c's
  // and chunk c - S's to the same 4 only if S is even
  if (CR % SCR_CONSUMERS) S = S < 2 ? 2 : S & ~1;
  // pairs per owner: as many h rows as fit in SCR_H_BYTES
  int M = (int)(SCR_H_BYTES / ((size_t)d * sizeof(float)));
  M = M < 1 ? 1 : (M > SCR_MAX_PAIRS ? SCR_MAX_PAIRS : M);
  const size_t smem = (size_t)S * chunk + ((size_t)M * ((d + 3) & ~3) + R) * sizeof(float);
  if (chunk >= (1u << 20)) return (int)cudaErrorInvalidValue;  // mbarrier tx count
  if ((err = l2s_allow_smem(screened_logits_kernel, smem)) != cudaSuccess) return (int)err;
  screened_logits_kernel<<<dim3(K * P, B), SCR_THREADS, smem, (cudaStream_t)stream>>>(
      W, b, h, ids, out, K, n_blk, d, P, CR, S, M);
  return (int)cudaGetLastError();
}

