// Device routines shared by the L2S kernels (screen.cu, fused_topk.cu), and the
// launch helpers every kernel library uses (l2s_allow_smem, l2s_error_string).
// route.cu has its own dot product: one warp per cluster, all rows of h at once.
//
// One summation order for every dot product: screen.cu and fused_topk.cu both
// compute a tile's logits through l2s_tile_logits, so the unfused and fused
// decode paths give bit-identical logits, ids and values on the card, as the
// two Pallas kernels do on the TPU.
//
// Each routine takes the packed head and h in float32 or in bfloat16 (the
// weights' own dtype, as the Pallas kernels take it). A bfloat16 h is staged
// in shared memory as float32 (the conversion is exact), a bfloat16 weight is
// converted with __bfloat162float as it is loaded, and every product is an
// fmaf in float32: the product of two bfloat16 values is exact in float32, so
// this is the Pallas kernels' preferred_element_type=float32 dot.
#pragma once

#include <cuda_bf16.h>
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

// The bfloat16 twin of the dot above: lane l accumulates, with fmaf in
// ascending order, the 16-byte chunks (8 values) l, l+32, ... of the row when
// d % 8 == 0, the 8-byte chunks (4 values) when d % 4 == 0, else the single
// values; L2S_BATCH chunks a lane are in flight before it multiplies any of
// them, and the same xor butterfly ends it.
// The two bfloat16 values of a 32-bit word (the lower one first in memory)
// as float32: __bfloat162float's exact conversion, on the word's halves.
__device__ __forceinline__ void l2s_bf16x2(unsigned u, float& lo, float& hi) {
  lo = __uint_as_float(u << 16);
  hi = __uint_as_float(u & 0xffff0000u);
}

__device__ __forceinline__ float l2s_fma_bf16x4(uint2 w, float4 x, float acc) {
  float a, b;
  l2s_bf16x2(w.x, a, b);
  acc = fmaf(a, x.x, acc);
  acc = fmaf(b, x.y, acc);
  l2s_bf16x2(w.y, a, b);
  acc = fmaf(a, x.z, acc);
  return fmaf(b, x.w, acc);
}

__device__ __forceinline__ float l2s_warp_dot(const __nv_bfloat16* __restrict__ row,
                                              const float* __restrict__ h_s,
                                              int d, int lane) {
  float acc = 0.f;
  const float4* h4 = reinterpret_cast<const float4*>(h_s);
  if ((d & 7) == 0) {
    const uint4* row8 = reinterpret_cast<const uint4*>(row);
    const int d8 = d >> 3;
    for (int c0 = lane; c0 < d8; c0 += 32 * L2S_BATCH) {
      uint4 w[L2S_BATCH];
#pragma unroll
      for (int u = 0; u < L2S_BATCH; ++u) {
        const int c = c0 + 32 * u;
        w[u] = c < d8 ? __ldg(row8 + c) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < L2S_BATCH; ++u) {
        const int c = c0 + 32 * u;
        if (c < d8) {
          acc = l2s_fma_bf16x4(make_uint2(w[u].x, w[u].y), h4[2 * c], acc);
          acc = l2s_fma_bf16x4(make_uint2(w[u].z, w[u].w), h4[2 * c + 1], acc);
        }
      }
    }
  } else if ((d & 3) == 0) {
    const uint2* row4 = reinterpret_cast<const uint2*>(row);
    const int d4 = d >> 2;
    for (int c0 = lane; c0 < d4; c0 += 32 * L2S_BATCH) {
      uint2 w[L2S_BATCH];
#pragma unroll
      for (int u = 0; u < L2S_BATCH; ++u) {
        const int c = c0 + 32 * u;
        w[u] = c < d4 ? __ldg(row4 + c) : make_uint2(0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < L2S_BATCH; ++u) {
        const int c = c0 + 32 * u;
        if (c < d4) acc = l2s_fma_bf16x4(w[u], h4[c], acc);
      }
    }
  } else {
#pragma unroll 4
    for (int c = lane; c < d; c += 32)
      acc = fmaf(__bfloat162float(__ldg(row + c)), h_s[c], acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

__device__ __forceinline__ float l2s_load(const float* __restrict__ p) { return __ldg(p); }
__device__ __forceinline__ float l2s_load(const __nv_bfloat16* __restrict__ p) {
  return __bfloat162float(__ldg(p));
}

// The logits of `rows` consecutive rows of a gathered weight tile (one part
// of the tile in screen.cu and in fused_topk.cu), T = float or __nv_bfloat16:
//   out[row] = W_tile[row] . h + b_tile[row]      (float32)
// one warp per row, rows dealt round robin over the block's warps. The tile
// (L2S_V_BLK x d weights, 256,000 bytes at d = 500 in float32) is streamed
// from global memory row by row and never staged whole: it does not fit in
// one block's shared memory.
template <typename T>
__device__ __forceinline__ void l2s_tile_logits(const T* __restrict__ w_tile,
                                                const T* __restrict__ b_tile,
                                                const float* __restrict__ h_s,
                                                int d, float* __restrict__ out,
                                                int rows) {
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int row = threadIdx.x >> 5; row < rows; row += nwarps) {
    const float bias = l2s_load(b_tile + row);   // in flight with the row's loads
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

// The same from n bfloat16 values, converted exactly to float32: 16-byte
// loads (8 values) when n % 8 == 0, single values otherwise.
__device__ __forceinline__ void l2s_stage(const __nv_bfloat16* __restrict__ src,
                                          float* __restrict__ dst, int n) {
  if ((n & 7) == 0) {
    const uint4* s8 = reinterpret_cast<const uint4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < (n >> 3); i += blockDim.x) {
      const uint4 w = __ldg(s8 + i);
      float4 a, b;
      l2s_bf16x2(w.x, a.x, a.y);
      l2s_bf16x2(w.y, a.z, a.w);
      l2s_bf16x2(w.z, b.x, b.y);
      l2s_bf16x2(w.w, b.z, b.w);
      d4[2 * i] = a;
      d4[2 * i + 1] = b;
    }
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = __bfloat162float(src[i]);
  }
}

// The most static shared memory any kernel of these libraries declares
// (route.cu's merge buffers: 576 bytes at 8 rows of h a block).
#define L2S_STATIC_SMEM_MAX 1024

// Raise a kernel's dynamic shared-memory limit to ``bytes`` when its static
// and dynamic shared memory together may pass the default 48 KB: the default
// bounds their sum, so 48 KB of dynamic memory beside any static memory
// needs the opt-in too (the route kernel at d = 1536 stages 8 rows of h in
// exactly 48 KB beside 576 static bytes, and its launch was refused).
template <typename Kernel>
static cudaError_t l2s_allow_smem(Kernel kernel, size_t bytes) {
  if (bytes + L2S_STATIC_SMEM_MAX <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

extern "C" const char* l2s_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
