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
// Design: grid (K * P, B). Block (part p, slot j, row i) owns rows
// [p*R, (p+1)*R) of slot j's tile, R = 128 / P, with P chosen by the wrapper
// so that B * K * P blocks cover the SMs (P = 8 at B = 4, K = 16: 512 blocks).
//   Phase A, every block:
//   1. a valid slot stages h[i] and computes its R logits through
//      l2s_tile_logits, the routine screen.cu uses (one warp per row, the
//      same summation order), so fused and unfused logits are bit-identical;
//      a sentinel slot reads no weights at all;
//   2. warp 0 reduces the part's (max, sum-exp) over its R logits; a
//      sentinel part gives (-inf, 0);
//   3. with noise, noise[i, j, row] is added after that (Gumbel-max sampling
//      keeps log Z exact);
//   4. each of the R values finds its rank by (value desc, position asc),
//      position = j*128 + row, and the first kk = min(k, R) land in the
//      part's sorted list; a sentinel part lists (NEG_INF, its first kk
//      positions), as a stable sort of the masked unfused row would order
//      them;
//   5. the list and the pair go to scratch, __threadfence(), and one atomic
//      increment of row i's counter.
//   Phase B, the block that brings row i's counter to K * P (the last of the
//   row to finish) resets it to 0 for the next launch and merges the row:
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
// Shared memory in phase B holds only each list's head index, the value and
// position at its head, its max and its sum (20 bytes a list: 40 KB at
// K*P = 2,000); an advanced list's next entry is read from the scratch in L2
// (__ldcg), where the blocks of phase A left it. So every k <= K*128 is
// served, for K*P up to 11,622 lists; the lists themselves (8 bytes an
// entry) pass 227 KB from K >= 225 tiles at k >= 128.
//
// The weights and h come in float32 or in bfloat16 (fused_topk_kernel and
// fused_topk_bf16_kernel, one body): the logits, the noise, the lists and
// the outputs are float32 either way, and bfloat16 logits are the bits
// screen.cu's bfloat16 kernel gives.
#include <limits.h>

#include "l2s_common.cuh"

#define FT_THREADS 256   // 8 warps: R = 16..128 rows a block, 2..16 per warp
#define FT_SMEM_OPTIN (227 * 1024)   // shared memory one block may opt into

__device__ __forceinline__ bool ft_before(float v, int p, float ov, int op) {
  return v > ov || (v == ov && p < op);
}

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
      float m = -INFINITY;
      for (int r = lane; r < R; r += 32) m = fmaxf(m, x[r]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      float s = 0.f;
      for (int r = lane; r < R; r += 32) s += expf(x[r] - m);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
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

  const size_t q0 = (size_t)i * L;
  const float* gv = part_v + q0 * kk;        // the row's L lists of kk, list-major
  const int* gp = part_p + q0 * kk;
  int* head = reinterpret_cast<int*>(sm);    // L: next entry of each list
  float* hv = reinterpret_cast<float*>(head + L);  // L: its value (-inf: spent)
  int* hp = reinterpret_cast<int*>(hv + L);  // L: its position (INT_MAX: spent)
  float* lm = reinterpret_cast<float*>(hp + L);  // L part maxima
  float* ls = lm + L;                        // L part sums
  for (int l = t; l < L; l += blockDim.x) {
    head[l] = 0;
    hv[l] = __ldcg(gv + (size_t)l * kk);
    hp[l] = __ldcg(gp + (size_t)l * kk);
    lm[l] = __ldcg(part_m + q0 + l);
    ls[l] = __ldcg(part_s + q0 + l);
  }
  __syncthreads();

  if (warp == 1) {
    float m = -INFINITY;
    for (int l = lane; l < L; l += 32) m = fmaxf(m, lm[l]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float s = 0.f;
    for (int l = lane; l < L; l += 32)
      if (lm[l] > -INFINITY) s += ls[l] * expf(lm[l] - m);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) out_logz[i] = m + logf(s);  // -inf + log 0 = -inf: all sentinel
  } else if (warp == 0) {
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
