// cluster_route: z = argmax_t v_t . h for each row of h (paper Eq. (2)).
//
// Replaces the Pallas kernel src/repro/kernels/route.py::cluster_route
// (_route_kernel, pl.pallas_call at route.py:49), which does one
// (128, d) x (d, r_pad) MXU product per 128 rows and an argmax in registers.
//
// Bound on the H100: bytes. It must read v (r x d floats: 200 KB at r = 100,
// d = 500; 1 MB at zamba2-2.7b's d = 2560) and h once, and does 2*B*r*d
// flops, far below the card's float32 rate. At decode batch sizes (B = 1..8)
// the bytes take well under a microsecond, so the floor is one launch plus
// one round trip to device memory.
//
// Design: parallel over the clusters t, not over the rows of h (one block
// per row would use 4 of 132 SMs at B = 4 and read all of v in each).
//   * One thread block cluster of up to 16 blocks of 8 warps covers r = 100
//     in one wave (13 blocks, one warp per t); the grid is ceil(B / BT) such
//     clusters, each owning BT rows of h, staged (zero-padded) in shared
//     memory. BT is 8 where eight rows of d floats fit ROUTE_SMEM (220 KB:
//     d <= 7,040), else 4, 2 or 1 (d <= 56,320): qwen1.5-110b's d = 8192
//     stages 4 rows in 128 KB. A row's sums do not depend on BT, so every
//     BT gives the same routes. 16 is Hopper's non-portable cluster size: 13 blocks
//     of 8 warps spread the reads of v over twice the SMs that 7 blocks of
//     16 warps would, and one SM streams only a small share of the card's
//     memory rate.
//   * One warp per cluster t (then t + W, t + 2W, ... when r exceeds the W
//     warps of the cluster): it reads v_t from device memory once, with
//     ROUTE_LOADS = 10 16-byte loads per lane in flight before the first FMA
//     (the first batch is issued before h is staged, so the two round trips
//     overlap), dots it with all BT rows (BT partial sums per lane, fmaf in
//     ascending chunk order), and reduces them with xor shuffles. A ragged d
//     (d % 4 != 0) takes 4-byte loads instead.
//   * Reduction warp -> block -> cluster: lane b of each warp keeps row b's
//     best (score, t), one thread per row merges the block's warps, and
//     block rank 0 merges the cluster's blocks through distributed shared
//     memory (map_shared_rank) and writes out. Every merge orders by
//     (score desc, t asc), so the first index wins a tie, as jnp.argmax does,
//     whatever order the blocks run in.
// One launch, no (B, r) score matrix, no workspace, no atomics.
//
// h comes in float32 or in bfloat16 (route_kernel and route_bf16_kernel, one
// body), v in float32, as fit_l2s makes it: a bfloat16 h is converted to
// float32 as it is staged (exactly), so the scores are the float32 kernel's
// scores of the same values, as the Pallas kernel's promoted float32 dot
// gives them.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W; CUDA-event
// medians, cold L2), B = 4, r = 100: 0.0098 ms at d = 500 (argmax(h @ v.T)
// 0.0148 ms) and 0.0133 ms at d = 2560 (argmax(h @ v.T) 0.0189 ms). The
// bound is 0.00006 and 0.0003 ms: launch and one round trip to memory
// dominate.
#include <cooperative_groups.h>

#include "l2s_common.cuh"

namespace cg = cooperative_groups;

#define ROUTE_SMEM (220 * 1024)  // shared memory for the staged rows of h
#define ROUTE_THREADS 256     // 8 warps per block
#define ROUTE_WARPS (ROUTE_THREADS / 32)
#define ROUTE_MAX_CLUSTER 16  // a non-portable cluster size (Hopper allows 16)
#define ROUTE_LOADS 10        // loads of v in flight per lane

// (s, t) beats the best so far (m, mt): a higher score, or an equal one at a
// lower index; t < 0 marks "no cluster seen".
__device__ __forceinline__ bool route_better(float s, int t, float m, int mt) {
  return t >= 0 && (mt < 0 || s > m || (s == m && t < mt));
}

// One batch of a row of v: up to ROUTE_LOADS elements (float4 when VEC, else
// float in .x) at lane + 32u past c0; 0 past the end n.
template <bool VEC>
__device__ __forceinline__ void route_load(float4 (&w)[ROUTE_LOADS],
                                           const float* __restrict__ row, int c0, int n) {
#pragma unroll
  for (int u = 0; u < ROUTE_LOADS; ++u) {
    const int c = c0 + 32 * u;
    if (VEC)
      w[u] = c < n ? __ldg(reinterpret_cast<const float4*>(row) + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    else
      w[u] = make_float4(c < n ? __ldg(row + c) : 0.f, 0.f, 0.f, 0.f);
  }
}

// BT rows of h from row b0 (rows of them real, the rest zero) into h_s as
// float32: float4 chunks when VEC (d % 4 == 0), else single values.
template <bool VEC, int BT>
__device__ __forceinline__ void route_stage(const float* __restrict__ h, float* h_s,
                                            int b0, int rows, int d) {
  const int n = VEC ? d >> 2 : d;
  const int dp = (d + 3) & ~3;
  if (VEC) {
    float4* h4 = reinterpret_cast<float4*>(h_s);
    const float4* src = reinterpret_cast<const float4*>(h + (size_t)b0 * d);
#pragma unroll 4
    for (int i = threadIdx.x; i < BT * n; i += ROUTE_THREADS)
      h4[i] = i < rows * n ? __ldg(src + i) : make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (int i = threadIdx.x; i < BT * dp; i += ROUTE_THREADS) {
      const int b = i / dp, c = i - b * dp;
      h_s[i] = (b < rows && c < d) ? __ldg(h + (size_t)(b0 + b) * d + c) : 0.f;
    }
  }
}

// The same from a bfloat16 h: 8-byte chunks of 4 values when VEC.
template <bool VEC, int BT>
__device__ __forceinline__ void route_stage(const __nv_bfloat16* __restrict__ h,
                                            float* h_s, int b0, int rows, int d) {
  const int n = VEC ? d >> 2 : d;
  const int dp = (d + 3) & ~3;
  if (VEC) {
    float4* h4 = reinterpret_cast<float4*>(h_s);
    const uint2* src = reinterpret_cast<const uint2*>(h + (size_t)b0 * d);
#pragma unroll 4
    for (int i = threadIdx.x; i < BT * n; i += ROUTE_THREADS) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < rows * n) {
        const uint2 w = __ldg(src + i);
        l2s_bf16x2(w.x, x.x, x.y);
        l2s_bf16x2(w.y, x.z, x.w);
      }
      h4[i] = x;
    }
  } else {
    for (int i = threadIdx.x; i < BT * dp; i += ROUTE_THREADS) {
      const int b = i / dp, c = i - b * dp;
      h_s[i] = (b < rows && c < d) ? __bfloat162float(h[(size_t)(b0 + b) * d + c]) : 0.f;
    }
  }
}

// VEC: d % 4 == 0, v read as float4; else as single floats (ragged d).
// HT: h's type, float or __nv_bfloat16. BT: rows of h per cluster.
template <bool VEC, int BT, typename HT>
__device__ __forceinline__ void route_body(const HT* __restrict__ h,
                                           const float* __restrict__ v,
                                           int* __restrict__ out, int B, int r, int d) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];
  float* h_s = reinterpret_cast<float*>(smem4);  // BT x dp floats
  __shared__ float warp_val[ROUTE_WARPS][BT];
  __shared__ int warp_idx[ROUTE_WARPS][BT];
  __shared__ float blk_val[BT];
  __shared__ int blk_idx[BT];

  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  const int b0 = (int)(blockIdx.x / csize) * BT;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = csize * ROUTE_WARPS;
  const int t_first = rank * ROUTE_WARPS + warp;
  const int n = VEC ? d >> 2 : d;                // elements of a row of v
  const int dp = (d + 3) & ~3;

  // The first batch of this warp's first cluster is in flight while h is
  // staged, so the two round trips to memory overlap.
  float4 w[ROUTE_LOADS];
  if (t_first < r) route_load<VEC>(w, v + (size_t)t_first * d, lane, n);
  const int rows = min(BT, B - b0);
  route_stage<VEC, BT>(h, h_s, b0, rows, d);
  __syncthreads();

  // lane b < BT keeps row b's best (score, t) over this warp's clusters
  float best = -INFINITY;
  int best_t = -1;
  for (int t = t_first; t < r; t += nwarps) {
    float acc[BT];
#pragma unroll
    for (int b = 0; b < BT; ++b) acc[b] = 0.f;
    const float* row = v + (size_t)t * d;
    for (int c0 = lane; c0 < n; c0 += 32 * ROUTE_LOADS) {
      if (t != t_first || c0 != lane) route_load<VEC>(w, row, c0, n);
#pragma unroll
      for (int u = 0; u < ROUTE_LOADS; ++u) {
        const int c = c0 + 32 * u;
        if (c >= n) break;
#pragma unroll
        for (int b = 0; b < BT; ++b) {
          if (VEC) {
            const float4 x = reinterpret_cast<const float4*>(h_s)[b * n + c];
            acc[b] = fmaf(w[u].x, x.x, acc[b]);
            acc[b] = fmaf(w[u].y, x.y, acc[b]);
            acc[b] = fmaf(w[u].z, x.z, acc[b]);
            acc[b] = fmaf(w[u].w, x.w, acc[b]);
          } else {
            acc[b] = fmaf(w[u].x, h_s[b * dp + c], acc[b]);
          }
        }
      }
    }
    float mine = 0.f;
#pragma unroll
    for (int b = 0; b < BT; ++b) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[b] += __shfl_xor_sync(0xffffffffu, acc[b], off);
      if (lane == b) mine = acc[b];
    }
    if (route_better(mine, t, best, best_t)) {
      best = mine;
      best_t = t;
    }
  }
  if (lane < BT) {
    warp_val[warp][lane] = best;
    warp_idx[warp][lane] = best_t;
  }
  __syncthreads();
  if (threadIdx.x < BT) {
    const int b = threadIdx.x;
    float m = -INFINITY;
    int mt = -1;
    for (int q = 0; q < ROUTE_WARPS; ++q) {
      if (route_better(warp_val[q][b], warp_idx[q][b], m, mt)) {
        m = warp_val[q][b];
        mt = warp_idx[q][b];
      }
    }
    blk_val[b] = m;
    blk_idx[b] = mt;
  }
  cluster.sync();
  if (rank == 0 && threadIdx.x < BT) {
    const int b = threadIdx.x;
    float m = blk_val[b];
    int mt = blk_idx[b];
    for (int q = 1; q < csize; ++q) {
      const float s = cluster.map_shared_rank(blk_val, q)[b];
      const int t = cluster.map_shared_rank(blk_idx, q)[b];
      if (route_better(s, t, m, mt)) {
        m = s;
        mt = t;
      }
    }
    if (b < rows) out[b0 + b] = mt;
  }
  cluster.sync();  // every block's shared memory lives until rank 0 has read it
}

template <bool VEC, int BT>
__global__ void __launch_bounds__(ROUTE_THREADS)
route_kernel(const float* __restrict__ h, const float* __restrict__ v,
             int* __restrict__ out, int B, int r, int d) {
  route_body<VEC, BT>(h, v, out, B, r, d);
}

template <bool VEC, int BT>
__global__ void __launch_bounds__(ROUTE_THREADS)
route_bf16_kernel(const __nv_bfloat16* __restrict__ h, const float* __restrict__ v,
                  int* __restrict__ out, int B, int r, int d) {
  route_body<VEC, BT>(h, v, out, B, r, d);
}

// The kernels of one h type, by [!VEC][log2 BT].
typedef const void* RouteKernels[2][4];

template <typename HT>
static int route_launch(const RouteKernels& kernels, const HT* h, const float* v,
                        int* out, int B, int r, int d, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (r <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const size_t row = (size_t)((d + 3) & ~3) * sizeof(float);
  int lbt = 3;                                   // BT = 8, 4, 2, 1
  while (lbt > 0 && (row << lbt) > ROUTE_SMEM) --lbt;
  if (row > ROUTE_SMEM) return (int)cudaErrorInvalidValue;
  const int bt = 1 << lbt;
  const size_t smem = row << lbt;
  const void* kernel = kernels[(d & 3) != 0][lbt];
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) err = l2s_allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  int csize = (r + ROUTE_WARPS - 1) / ROUTE_WARPS;
  if (csize > ROUTE_MAX_CLUSTER) csize = ROUTE_MAX_CLUSTER;
  const int groups = (B + bt - 1) / bt;

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(groups * csize));
  cfg.blockDim = dim3(ROUTE_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {(void*)&h, (void*)&v, (void*)&out, (void*)&B, (void*)&r, (void*)&d};
  err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

#define ROUTE_ROW(K, VEC) \
  { (const void*)K<VEC, 1>, (const void*)K<VEC, 2>, (const void*)K<VEC, 4>, \
    (const void*)K<VEC, 8> }

// h (B, d) f32, v (r, d) f32, out (B,) int32; all contiguous on one device,
// h and v 16-byte aligned; r >= 1, and d at most 56,320 (one row of h must
// fit ROUTE_SMEM). Returns a cudaError_t (0 on success).
extern "C" int l2s_cluster_route(const float* h, const float* v, int* out, int B,
                                 int r, int d, void* stream) {
  static const RouteKernels k = {ROUTE_ROW(route_kernel, true),
                                 ROUTE_ROW(route_kernel, false)};
  return route_launch(k, h, v, out, B, r, d, stream);
}

// The same with h in bfloat16 (v stays float32).
extern "C" int l2s_cluster_route_bf16(const void* h, const float* v, int* out, int B,
                                      int r, int d, void* stream) {
  static const RouteKernels k = {ROUTE_ROW(route_bf16_kernel, true),
                                 ROUTE_ROW(route_bf16_kernel, false)};
  return route_launch(k, static_cast<const __nv_bfloat16*>(h), v, out, B, r, d,
                      stream);
}
