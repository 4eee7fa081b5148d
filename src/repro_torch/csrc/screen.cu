// screened_logits: the raw logits of every routed candidate tile,
//   out[i, j, :] = W_blocks[block_ids[i, j]] . h[i] + b_blocks[block_ids[i, j]]
//
// Replaces the Pallas kernel src/repro/kernels/screen.py::screened_logits
// (_screened_logits_kernel, pl.pallas_call at screen.py:68), whose scalar
// prefetch chooses which (128, d) tile of W each (row, slot) program DMAs.
// As there, a sentinel id (outside [0, n_blk)) reads tile 0 and its output is
// left unmasked: the caller (kernels/ops.py) masks it.
//
// Bound on the H100: bytes. Each (row, slot) streams one 128 x d float tile
// (256,000 bytes at d = 500) for 2 flops per weight; the whole call moves the
// distinct tiles once and writes B*K*128 floats.
//
// Design: grid (B, K), one block per (row, slot), so a decode batch of
// B = 8 rows x K = 16 slots puts a block on almost every SM. The block stages
// h[i] in shared memory; a tile is too large to stage (more than the 227 KB a
// block may have), so l2s_tile_logits streams it row by row, one warp per row,
// over d in float4 chunks with the ragged end masked, each lane with 8
// float4 loads in flight. Not yet done: a grid that cuts tiles into parts, as
// fused_topk.cu does, for decode batches with few (row, slot) pairs.
#include "l2s_common.cuh"

__global__ void __launch_bounds__(L2S_THREADS)
screened_logits_kernel(const float* __restrict__ W, const float* __restrict__ b,
                       const float* __restrict__ h, const int* __restrict__ ids,
                       float* __restrict__ out, int K, int n_blk, int d) {
  extern __shared__ float4 smem4[];
  float* h_s = reinterpret_cast<float*>(smem4);  // d floats
  const int i = blockIdx.x;
  const int j = blockIdx.y;
  int blk = ids[(size_t)i * K + j];
  if (blk < 0 || blk >= n_blk) blk = 0;  // sentinel: tile 0, masked by the caller
  l2s_stage(h + (size_t)i * d, h_s, d);
  __syncthreads();
  l2s_tile_logits(W + (size_t)blk * L2S_V_BLK * d, b + (size_t)blk * L2S_V_BLK, h_s,
                  d, out + ((size_t)i * K + j) * L2S_V_BLK, L2S_V_BLK);
}

// W (n_blk, 128, d) f32, b (n_blk, 128) f32, h (B, d) f32, ids (B, K) int32,
// out (B, K, 128) f32; all contiguous on one device, W and h 16-byte aligned.
// Returns a cudaError_t (0 on success).
extern "C" int l2s_screened_logits(const float* W, const float* b, const float* h,
                                   const int* ids, float* out, int B, int K,
                                   int n_blk, int d, void* stream) {
  if (B <= 0 || K <= 0) return (int)cudaSuccess;
  const size_t smem = (size_t)d * sizeof(float);
  cudaError_t err = l2s_allow_smem(screened_logits_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  screened_logits_kernel<<<dim3(B, K), L2S_THREADS, smem, (cudaStream_t)stream>>>(
      W, b, h, ids, out, K, n_blk, d);
  return (int)cudaGetLastError();
}
