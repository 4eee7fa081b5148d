// screened_logits: the raw logits of every routed candidate tile,
//   out[i, j, :] = W_blocks[block_ids[i, j]] . h[i] + b_blocks[block_ids[i, j]]
//
// Replaces the Pallas kernel src/repro/kernels/screen.py::screened_logits
// (_screened_logits_kernel, pl.pallas_call at screen.py:68), whose scalar
// prefetch chooses which (128, d) tile of W each (row, slot) program DMAs.
// As there, a sentinel id (outside [0, n_blk)) reads tile 0 and its output is
// left unmasked: the caller (kernels/ops.py) masks it.
//
// Bound on the H100: bytes. The call must read each distinct tile among the
// B*K ids once (128 x d floats, 256,000 bytes at d = 500), for 2 flops per
// weight and (row, slot), and write B*K*128 floats.
//
// Design: grid (B, K*P), one block per (row i, slot j, part p of the tile).
// Block (i, j*P + p) owns rows [p*R, (p+1)*R) of slot j's tile, R = 128 / P,
// with P chosen by the wrapper (kernels/screen.py::screen_parts) so that a
// decode batch fills the SMs: at B = 4, K = 16 P = 1 gives 64 blocks, the
// rule picks P = 4 (256) at d = 500 and P = 8 (512) at d = 2560, where wider
// rows need more warps per SM. Rows are the fastest grid index, so the
// blocks of different rows that read the same tile at the same slot (a
// beam's hypotheses, the full-cover screen) run side by side and share it
// in L2.
// The block stages h[i] in shared memory and l2s_tile_logits streams its R
// rows, one warp per row, over d in float4 chunks with the ragged end
// masked, each lane with 8 float4 loads in flight, in l2s_warp_dot's
// summation order: these logits are bit-identical to fused_topk.cu's and do
// not depend on P.
// The weights and h come in float32 or in bfloat16 (screened_logits_kernel
// and screened_logits_bf16_kernel, one body): a bfloat16 tile is half the
// bytes, h is staged as float32, and the logits are float32 either way.
#include "l2s_common.cuh"

template <typename T>
__device__ __forceinline__ void screened_logits_body(const T* __restrict__ W,
                                                     const T* __restrict__ b,
                                                     const T* __restrict__ h,
                                                     const int* __restrict__ ids,
                                                     float* __restrict__ out, int K,
                                                     int n_blk, int d, int P) {
  extern __shared__ float4 smem4[];
  float* h_s = reinterpret_cast<float*>(smem4);  // d floats
  const int i = blockIdx.x;
  const int j = blockIdx.y / P;
  const int R = L2S_V_BLK / P;
  const int r0 = (blockIdx.y - j * P) * R;
  int blk = ids[(size_t)i * K + j];
  if (blk < 0 || blk >= n_blk) blk = 0;  // sentinel: tile 0, masked by the caller
  l2s_stage(h + (size_t)i * d, h_s, d);
  __syncthreads();
  const size_t row0 = (size_t)blk * L2S_V_BLK + r0;
  l2s_tile_logits(W + row0 * d, b + row0, h_s, d,
                  out + ((size_t)i * K + j) * L2S_V_BLK + r0, R);
}

__global__ void __launch_bounds__(L2S_THREADS)
screened_logits_kernel(const float* __restrict__ W, const float* __restrict__ b,
                       const float* __restrict__ h, const int* __restrict__ ids,
                       float* __restrict__ out, int K, int n_blk, int d, int P) {
  screened_logits_body(W, b, h, ids, out, K, n_blk, d, P);
}

__global__ void __launch_bounds__(L2S_THREADS)
screened_logits_bf16_kernel(const __nv_bfloat16* __restrict__ W,
                            const __nv_bfloat16* __restrict__ b,
                            const __nv_bfloat16* __restrict__ h,
                            const int* __restrict__ ids, float* __restrict__ out,
                            int K, int n_blk, int d, int P) {
  screened_logits_body(W, b, h, ids, out, K, n_blk, d, P);
}

template <typename T, typename Kernel>
static int screened_logits_launch(Kernel kernel, const T* W, const T* b, const T* h,
                                  const int* ids, float* out, int B, int K, int n_blk,
                                  int d, int P, void* stream) {
  if (B <= 0 || K <= 0) return (int)cudaSuccess;
  if (P < 1 || P > 8 || L2S_V_BLK % P || (long)K * P > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)d * sizeof(float);
  cudaError_t err = l2s_allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(B, K * P), L2S_THREADS, smem, (cudaStream_t)stream>>>(
      W, b, h, ids, out, K, n_blk, d, P);
  return (int)cudaGetLastError();
}

// W (n_blk, 128, d) f32, b (n_blk, 128) f32, h (B, d) f32, ids (B, K) int32,
// out (B, K, 128) f32; all contiguous on one device, W and h 16-byte aligned;
// each tile cut into P parts, P in {1, 2, 4, 8}, K * P <= 65535 (grid y).
// Returns a cudaError_t (0 on success).
extern "C" int l2s_screened_logits(const float* W, const float* b, const float* h,
                                   const int* ids, float* out, int B, int K,
                                   int n_blk, int d, int P, void* stream) {
  return screened_logits_launch(screened_logits_kernel, W, b, h, ids, out, B, K,
                                n_blk, d, P, stream);
}

// The same with W, b and h in bfloat16 (out stays float32).
extern "C" int l2s_screened_logits_bf16(const void* W, const void* b, const void* h,
                                        const int* ids, float* out, int B, int K,
                                        int n_blk, int d, int P, void* stream) {
  return screened_logits_launch(
      screened_logits_bf16_kernel, static_cast<const __nv_bfloat16*>(W),
      static_cast<const __nv_bfloat16*>(b), static_cast<const __nv_bfloat16*>(h),
      ids, out, B, K, n_blk, d, P, stream);
}
