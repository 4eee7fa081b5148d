// cluster_route: z = argmax_t v_t . h for each row of h (paper Eq. (2)).
//
// Replaces the Pallas kernel src/repro/kernels/route.py::cluster_route
// (_route_kernel, pl.pallas_call at route.py:49), which does one
// (128, d) x (d, r_pad) MXU product per 128 rows and an argmax in registers.
//
// Bound on the H100: bytes. It reads v (r x d floats, 200 KB at r = 100,
// d = 500) and h, and does 2*B*r*d flops, far below the card's float32 rate;
// at decode batch sizes the launch itself costs more than either.
//
// Design: one block per row of h (B blocks). The block stages its h row in
// shared memory; its warps take the rows of v round robin, load each row
// coalesced along d and reduce with warp shuffles (l2s_warp_dot). Each warp
// keeps its best (score, index) over its rows in ascending order, and thread
// 0 merges the warps' bests by (score desc, index asc): the first index wins
// a tie, as jnp.argmax does. No (B, r) score matrix is written.
#include "l2s_common.cuh"

__global__ void __launch_bounds__(L2S_THREADS)
route_kernel(const float* __restrict__ h, const float* __restrict__ v,
             int* __restrict__ out, int r, int d) {
  extern __shared__ float4 smem4[];
  float* h_s = reinterpret_cast<float*>(smem4);  // d floats
  __shared__ float warp_val[L2S_THREADS / 32];
  __shared__ int warp_idx[L2S_THREADS / 32];

  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  l2s_stage(h + (size_t)row * d, h_s, d);
  __syncthreads();

  float best = -INFINITY;
  int best_t = -1;
  for (int t = warp; t < r; t += nwarps) {
    const float s = l2s_warp_dot(v + (size_t)t * d, h_s, d, lane);
    if (best_t < 0 || s > best) {  // ascending t: a tie keeps the lower index
      best = s;
      best_t = t;
    }
  }
  if (lane == 0) {
    warp_val[warp] = best;
    warp_idx[warp] = best_t;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = warp_val[0];  // warp 0 always holds row t = 0
    int mt = warp_idx[0];
    for (int w = 1; w < nwarps; ++w) {
      const int t = warp_idx[w];
      if (t < 0) continue;
      const float s = warp_val[w];
      if (s > m || (s == m && t < mt)) {
        m = s;
        mt = t;
      }
    }
    out[row] = mt;
  }
}

// h (B, d) f32, v (r, d) f32, out (B,) int32; all contiguous on one device,
// h and v 16-byte aligned. Returns a cudaError_t (0 on success).
extern "C" int l2s_cluster_route(const float* h, const float* v, int* out, int B,
                                 int r, int d, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  const size_t smem = (size_t)d * sizeof(float);
  cudaError_t err = l2s_allow_smem(route_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  route_kernel<<<B, L2S_THREADS, smem, (cudaStream_t)stream>>>(h, v, out, r, d);
  return (int)cudaGetLastError();
}
