// Device routines shared by the L2S kernels (screen.cu, fused_topk.cu), and the
// launch helpers every kernel library uses (l2s_allow_smem, l2s_error_string).
// route.cu has its own dot product: one warp per cluster, all rows of h at once.
//
// One summation order for every dot product: screen.cu and fused_topk.cu both
// compute a tile's logits through l2s_tile_logits, so the unfused and fused
// decode paths give bit-identical logits, ids and values on the card, as the
// two Pallas kernels do on the TPU.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define L2S_V_BLK 128          // rows of one packed softmax tile (ops.pack_head_blocks)
#define L2S_NEG_INF (-1e30f)   // kernels/ref.py NEG_INF: sentinel slots and padded rows
#define L2S_THREADS 512        // screen.cu's block: 16 warps, enough loads in flight per SM

// Dot product of one d-float row in global memory with h staged in shared
// memory, by one warp. Lane l accumulates (with fmaf, in ascending order) the
// float4 chunks l, l+32, l+64, ... of the row when d % 4 == 0, else the single
// floats l, l+32, ...; lanes past the ragged end of d add nothing. An xor
// butterfly then leaves the same sum in every lane (float addition commutes,
// so each pair of partners adds the same two numbers). The float4 path loads
// L2S_BATCH chunks a lane before it multiplies any of them, so a warp keeps
// up to 4 KB in flight; the order of the sums is the same as one chunk at a
// time.
#define L2S_BATCH 8
__device__ __forceinline__ float l2s_warp_dot(const float* __restrict__ row,
                                              const float* __restrict__ h_s,
                                              int d, int lane) {
  float acc = 0.f;
  if ((d & 3) == 0) {
    const float4* row4 = reinterpret_cast<const float4*>(row);
    const float4* h4 = reinterpret_cast<const float4*>(h_s);
    const int d4 = d >> 2;
    for (int c0 = lane; c0 < d4; c0 += 32 * L2S_BATCH) {
      float4 w[L2S_BATCH];
#pragma unroll
      for (int u = 0; u < L2S_BATCH; ++u) {
        const int c = c0 + 32 * u;
        w[u] = c < d4 ? __ldg(row4 + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < L2S_BATCH; ++u) {
        const int c = c0 + 32 * u;
        if (c < d4) {
          const float4 x = h4[c];
          acc = fmaf(w[u].x, x.x, acc);
          acc = fmaf(w[u].y, x.y, acc);
          acc = fmaf(w[u].z, x.z, acc);
          acc = fmaf(w[u].w, x.w, acc);
        }
      }
    }
  } else {
#pragma unroll 4
    for (int c = lane; c < d; c += 32) acc = fmaf(__ldg(row + c), h_s[c], acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

// The logits of `rows` consecutive rows of a gathered weight tile (one part
// of the tile in screen.cu and in fused_topk.cu):
//   out[row] = W_tile[row] . h + b_tile[row]
// one warp per row, rows dealt round robin over the block's warps. The tile
// (L2S_V_BLK x d floats, 256,000 bytes at d = 500) is streamed from global memory row
// by row and never staged whole: it does not fit in one block's shared memory.
__device__ __forceinline__ void l2s_tile_logits(const float* __restrict__ w_tile,
                                                const float* __restrict__ b_tile,
                                                const float* __restrict__ h_s,
                                                int d, float* __restrict__ out,
                                                int rows) {
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int row = threadIdx.x >> 5; row < rows; row += nwarps) {
    const float bias = __ldg(b_tile + row);   // in flight with the row's loads
    const float dot = l2s_warp_dot(w_tile + (size_t)row * d, h_s, d, lane);
    if (lane == 0) out[row] = dot + bias;
  }
}

// Copy n floats from global to shared memory with the whole block, as
// float4 when n % 4 == 0 (src and dst are then 16-byte aligned: h rows of a
// 16-byte aligned (B, d) tensor, and dynamic shared memory).
__device__ __forceinline__ void l2s_stage(const float* __restrict__ src,
                                          float* __restrict__ dst, int n) {
  if ((n & 3) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < (n >> 2); i += blockDim.x) d4[i] = __ldg(s4 + i);
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  }
}

// Raise a kernel's dynamic shared-memory limit when it needs more than the
// default 48 KB.
template <typename Kernel>
static cudaError_t l2s_allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

extern "C" const char* l2s_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
