// fused_screened_topk: gather + tile logits + sentinel mask + running top-k +
// online log Z over each query row's K candidate tiles, in one pass. Only
// ids (B, k), vals (B, k) and logZ (B,) reach device memory; the (B, K*128)
// candidate-logit row never does.
//
// Replaces the Pallas kernel src/repro/kernels/fused_topk.py::
// fused_screened_topk (_fused_topk_kernel and _merge_topk, pl.pallas_call at
// fused_topk.py:193). On the TPU the grid (B, K) runs in order on one core and
// VMEM scratch carries the running top-k and the (max, sum-exp) pair from
// slot j to slot j+1. Blocks of a CUDA grid run in no order and share
// nothing, so here one block owns a query row and a loop over the K slots
// takes the place of the sequential grid axis.
//
// Bound on the H100: bytes. A row streams its valid candidate tiles (each
// 128 x d floats, 256,000 bytes at d = 500) for 2 flops per weight; the merge
// and the log Z work on 128 values per slot.
//
// Design, per slot j of row i:
//   1. all warps compute the 128 tile logits into shared memory through
//      l2s_tile_logits, the routine screen.cu uses, so fused and unfused
//      logits are bit-identical;
//   2. warp 0 skips a sentinel slot in the online (max, sum-exp) update and
//      masks its logits to NEG_INF with the sentinel id n_blk*128; a valid
//      slot's word ids are blk*128 + lane;
//   3. with noise, warp 0 adds noise[i, j, :] to the valid logits after the
//      log Z update (Gumbel-max sampling keeps log Z exact);
//   4. warp 0 merges [running list (k_pad entries), tile (128)] by k rounds
//      of first-position argmax, each taken entry set to -inf: the order
//      _merge_topk relies on, so ties go to the lowest flattened
//      (slot-major, lane-minor) position, as jax.lax.top_k breaks them.
// The running list starts as (-inf, sentinel), so a row with fewer than k
// real candidates pads with NEG_INF and sentinel ids, and an all-sentinel row
// gets logZ = -inf. One block per row leaves most SMs idle at decode batch
// sizes: splitting K over several blocks with a second merge pass is the next
// step for speed.
#include "l2s_common.cuh"

__global__ void __launch_bounds__(L2S_THREADS)
fused_topk_kernel(const float* __restrict__ W, const float* __restrict__ b,
                  const float* __restrict__ h, const int* __restrict__ ids,
                  const float* __restrict__ noise, int* __restrict__ out_ids,
                  float* __restrict__ out_vals, float* __restrict__ out_logz,
                  int K, int n_blk, int d, int k, int k_pad) {
  extern __shared__ float4 smem4[];
  float* h_s = reinterpret_cast<float*>(smem4);   // d
  float* tile = h_s + ((d + 3) & ~3);              // 128 tile logits
  float* run_v = tile + L2S_V_BLK;                 // k_pad running top-k values
  int* run_i = reinterpret_cast<int*>(run_v + k_pad);          // k_pad ids
  float* pool_v = reinterpret_cast<float*>(run_i + k_pad);     // k_pad + 128
  int* pool_i = reinterpret_cast<int*>(pool_v + k_pad + L2S_V_BLK);

  const int i = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sentinel = n_blk * L2S_V_BLK;
  const int n_pool = k_pad + L2S_V_BLK;

  l2s_stage(h + (size_t)i * d, h_s, d);
  for (int p = threadIdx.x; p < k_pad; p += blockDim.x) {
    run_v[p] = -INFINITY;
    run_i[p] = sentinel;
  }
  // online (max, sum-exp), held alike by every lane of warp 0
  float m_run = -INFINITY;
  float s_run = 0.f;
  __syncthreads();

  for (int j = 0; j < K; ++j) {
    const int blk = ids[(size_t)i * K + j];
    const bool valid = blk >= 0 && blk < n_blk;
    const int safe = valid ? blk : 0;
    l2s_tile_logits(W + (size_t)safe * L2S_V_BLK * d, b + (size_t)safe * L2S_V_BLK,
                    h_s, d, tile);
    __syncthreads();

    if (warp == 0) {
      if (valid) {
        float tmax = -INFINITY;
        for (int q = lane; q < L2S_V_BLK; q += 32) tmax = fmaxf(tmax, tile[q]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
        const float m_new = fmaxf(m_run, tmax);
        float part = 0.f;
        for (int q = lane; q < L2S_V_BLK; q += 32) part += expf(tile[q] - m_new);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        s_run = s_run * expf(m_run - m_new) + part;
        m_run = m_new;
      }
      for (int p = lane; p < k_pad; p += 32) {
        pool_v[p] = run_v[p];
        pool_i[p] = run_i[p];
      }
      const float* nz = noise ? noise + ((size_t)i * K + j) * L2S_V_BLK : nullptr;
      for (int q = lane; q < L2S_V_BLK; q += 32) {
        float x = L2S_NEG_INF;
        if (valid) x = nz ? tile[q] + __ldg(nz + q) : tile[q];
        pool_v[k_pad + q] = x;
        pool_i[k_pad + q] = valid ? blk * L2S_V_BLK + q : sentinel;
      }
      __syncwarp();
      for (int t = 0; t < k; ++t) {
        // lane-local best over positions lane, lane+32, ... (ascending, so a
        // tie keeps the lower position); n_pool >= 256 > lane always
        float bv = pool_v[lane];
        int bp = lane;
        for (int p = lane + 32; p < n_pool; p += 32) {
          const float x = pool_v[p];
          if (x > bv) {
            bv = x;
            bp = p;
          }
        }
        // warp argmax by (value desc, position asc): a total order, so every
        // lane ends with the same (bv, bp)
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
          const int op = __shfl_xor_sync(0xffffffffu, bp, off);
          if (ov > bv || (ov == bv && op < bp)) {
            bv = ov;
            bp = op;
          }
        }
        if (lane == 0) {
          run_v[t] = bv;
          run_i[t] = pool_i[bp];
          pool_v[bp] = -INFINITY;
        }
        __syncwarp();
      }
    }
    __syncthreads();  // the next slot overwrites `tile`
  }

  if (warp == 0) {
    for (int t = lane; t < k; t += 32) {
      out_vals[(size_t)i * k + t] = run_v[t];
      out_ids[(size_t)i * k + t] = run_i[t];
    }
    if (lane == 0) out_logz[i] = m_run + logf(s_run);
  }
}


// W (n_blk, 128, d) f32, b (n_blk, 128) f32, h (B, d) f32, ids (B, K) int32,
// noise (B, K, 128) f32 or null; out_ids (B, k) int32, out_vals (B, k) f32,
// out_logz (B,) f32; all contiguous on one device, W and h 16-byte aligned.
// Returns a cudaError_t (0 on success).
extern "C" int l2s_fused_screened_topk(const float* W, const float* b, const float* h,
                                       const int* ids, const float* noise,
                                       int* out_ids, float* out_vals, float* out_logz,
                                       int B, int K, int n_blk, int d, int k,
                                       void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  // h (d, rounded to float4), tile (128), running list (2 k_pad), pool
  // (2 (k_pad + 128)); past 227 KB (large d or k) the attribute call fails
  const int k_pad = (k + L2S_V_BLK - 1) / L2S_V_BLK * L2S_V_BLK;
  const size_t smem = ((size_t)((d + 3) & ~3) + L2S_V_BLK + 2 * (size_t)k_pad +
                       2 * ((size_t)k_pad + L2S_V_BLK)) * sizeof(float);
  cudaError_t err = l2s_allow_smem(fused_topk_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  fused_topk_kernel<<<B, L2S_THREADS, smem, (cudaStream_t)stream>>>(
      W, b, h, ids, noise, out_ids, out_vals, out_logz, K, n_blk, d, k, k_pad);
  return (int)cudaGetLastError();
}
