// ssd_intra_bwd: the gradient of the Mamba2 SSD intra-chunk dual form
// (ssd.cu), for every (batch, chunk, head). With M[t,s] = (C_t . B_s) E[t,s],
// E[t,s] = exp(l_t - l_s) for s <= t (else 0), w_s = exp(l_{Q-1} - l_s) and
// the upstream gradients dy (Q x P) and dS (N x P):
//
//   dxw = M^T dy + (w B) dS                    dM = dy xw^T (causal part)
//   dC  = (dM E) B                             dB = (dM E)^T C + w (xw dS^T)
//   dl_t += sum_s G[t,s],  dl_s -= sum_t G[t,s],  G = dM M
//   u_s = w_s B_s . (dS xw_s):  dl_s -= u_s,  dl_{Q-1} += sum_s u_s
//
// with dB and dC summed over the H / G heads of a group.
//
// Replaces the gradient XLA takes of the reference's intra-chunk einsums
// (src/repro/layers/ssm.py:116-125, the terms ssd_intra_pallas computes on the
// TPU); the Pallas kernel has no backward of its own.
//
// Bound on the H100: operations. Per (batch, chunk, head) the function needs
// five products over the causal half (C B^T, dy xw^T, M^T dy, (dM E)^T C and
// (dM E) B: 2 Q(Q+1)/2 (3N + 2P) flops) and two Q x N x P products (B dS and
// xw dS^T: 4 Q N P; u_s reuses xw dS^T). At zamba2-2.7b's chunk (B = 4, T =
// 512: nc = 2, Q = 256, H = 80, P = N = 64) that is 1.616e10 flops against
// 1.4e8 bytes of inputs and outputs (0.042 ms at 3.35 TB/s): 0.241 ms on the
// FMA units (67 TFLOP/s). The products run on the tensor cores in split
// TF32, three TF32 products for each float32 one, so this design's bound is
// 3 x 1.616e10 / 495 TFLOP/s = 0.098 ms (mamba2-1.3b's chunk, N = 128:
// 0.322 ms on the FMA units, 0.131 ms in split TF32).
//
// Split TF32 (3xTF32). Each operand is split into hi = cvt.rna.tf32(a) and
// lo = a - hi (exact) rounded the same way, and each product is lo_a hi_b +
// hi_a lo_b + hi_a hi_b by mma.sync.m16n8k8.tf32 into float32 accumulators
// (all tiles' lo_a hi_b first, so that no mma waits on the one before it).
// The dropped lo_a lo_b and the rounding of lo leave ~2^-21 of |a||b| per
// term against the 1e-4 of the largest magnitude this kernel is held to; the
// precision argument is tests/test_torch_train_ssm.py::
// test_split_tf32_precision, which emulates this split in every product of
// the closed form against the reference's vjp (one TF32 product alone misses
// 1e-4 there). The computed operands M = (C B^T) E and dM E are split from
// the registers that hold them. Everything that is not a product stays IEEE
// float32: the causal mask before expf (a dead position is 0, its exp never
// evaluated), w_s, G = dM M and its sums, u_s; no fast-math.
//
// Design: 256 threads (8 warps) a block, two kinds of block per (batch,
// chunk, head), one head's blocks side by side in a 1-D grid (its xw and dy
// stay in L2), the heaviest first.
//   * An s block owns 64 rows s and streams the 32-row t tiles at or after
//     them. Warps 0-3 (role 0) form (C B^T)^T and warps 4-7 (role 1) (dy
//     xw^T)^T, 16 rows s and all 32 columns t each, scale them by E^T in
//     registers to M^T and (dM E)^T, and use those registers directly as
//     the A operand (the accumulator's layout is m16n8k8's A layout with the
//     k slots permuted, and every B operand is read in the same permutation)
//     of dxw_s += M^T dy_t (role 0) and dB_s += (dM E)^T C_t (role 1). Role
//     1 hands its dM^T over in shared memory (bar.arrive; role 0 waits with
//     bar.sync: role 1 never waits) for G: its sums over t give dl_s, its
//     sums over s a partial of dl_t per t tile, written to scratch. Then the
//     state terms, from dS in 32-row chunks: Z = B_s dS (role 0: dxw += w Z,
//     u_s) and V = xw_s dS^T (role 1: dB += w V).
//   * A t block owns 128 rows t and streams the 32-row s tiles up to its
//     last row; each warp forms dy_t xw_s^T for 16 rows t and all 32 columns
//     s, masks and scales it to dM E in registers, and accumulates dC_t +=
//     (dM E) B_s.
// Products per causal 64 x 32 tile pair: C B^T, dy xw^T, M^T dy, (dM E)^T C
// in the s block, dy xw^T again and (dM E) B in the t block: six where the
// bound counts five (width-weighted, 3N + 3P against 3N + 2P). The t block
// forms dy xw^T again rather than partial sums of dC crossing blocks; it
// forms no C B^T (the s block's column sums of G give dl_t). A block covers
// the whole of N and P up to 128, so no product is repeated for a slice of
// N or P; a wider N or P is cut into 128-wide output slices, each its own
// block, which forms C B^T and dy xw^T again (those shapes only). A warp
// whose rows lie wholly past a streamed tile (s block) or before it (t
// block), or past Q, skips it.
//
// Staging: every tile (B, xw, C, dy, l, a chunk of dS) lands by cp.async
// (16-byte .cg copies, 4-byte where a width is ragged; zero-fill past Q, N
// and P). With N, P <= 64 the streamed tiles land in one slot and are split
// once there into high and low planes (bw_convert), which the products read
// while the next tile lands in the slot; otherwise two raw slots (B operands
// split as they are loaded), one where two do not fit. Rows are W = N or P
// rounded up to 32 floats, the column XOR-swizzled by 8 ((r >> 1 & 1) * 2 +
// ((r ^ r >> 2) & 1)): the float2 fragment loads (rows g, columns 2 tig) and
// the scalar ones (rows 2 tig, columns g) both hit 32 distinct banks with no
// padding. Shared memory (89 KB at zamba2's chunk, 105 KB at mamba2's) and
// 128 registers let two blocks share an SM; the products' k loops stay
// rolled, which measured faster than unrolled ones.
//
// Scratch: each head's dB and dC (2 BC Q H N floats, 83.9 MB at zamba2's
// chunk) and the partial sums of dl. The heads of a group are summed by a
// second kernel in ascending head order rather than in a block, so that the
// grid keeps every (batch, chunk, head) apart (640 x 6 blocks at zamba2's
// chunk); the round trip is 2 x 83.9 MB, ~0.05 ms at 3.35 TB/s. No atomics:
// dl is rows - columns - u, each summed in a fixed order, and the sum of u
// at row Q - 1 over s tiles in ascending order. Two launches on the same
// inputs give the same bits.
//
// Measured (chip_smoke.py --only train-ssm, [timing] ssd_intra_bwd, CUDA-event
// medians with L2 flushed; NVIDIA H100 80GB HBM3, 700.00 W): 0.85381 ms at
// zamba2's chunk (the FMA design before it: 1.39397 ms in the same call;
// 11.5 % of the split-TF32 bound) and 1.36415 ms at mamba2's (2.95430; 9.6 %).
// What bounds it is latency, not the tensor cores: mma.sync TF32 runs at
// ~320 TFLOP/s on this card (tools/mma_tf32_bench.cu), while much of a
// block's time goes outside the products (l and E, G's sums, splitting, each
// block's cp.async prologue, the dS chunks), and 16 warps an SM at 128
// registers leave no room to load the next k step's fragments early.
// wgmma on shared-memory operands and persistent blocks are the next step.
#include <stdint.h>

#include "l2s_common.cuh"

#define BW_T 64          // rows of a block's own tile
#define BW_U 32          // rows of a streamed tile
#define BW_THREADS 256   // 8 warps
#define BW_SMALL 320     // floats of the column sums of G and of l

// The swizzled offset of row r, column c of a tile W floats wide (W a
// multiple of 32): 4-float groups stay whole and aligned.
__device__ __forceinline__ int bw_at(int r, int c, int W) {
  return r * W + (c ^ (((r & 2) << 3) | (((r ^ (r >> 2)) & 1) << 3)));
}

__device__ __forceinline__ void bw_cp16(float* dst, const float* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void bw_cp4(float* dst, const float* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void bw_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void bw_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Queue copies of a tile of `rows` rows W wide: row r, column c <- src[(r0 +
// r) * sld + c]; zero where r0 + r >= rmax or c >= cmax. 16-byte copies when
// vec (cmax, sld and src all multiples of 4 floats), else 4-byte.
__device__ __forceinline__ void bw_stage(float* dst, int W, const float* src,
                                         size_t sld, int r0, int rmax, int cmax,
                                         bool vec, int rows = BW_T) {
  // element i = r * n + c of the tile (n per row) walks by BW_THREADS: r and c
  // step by dr and dc, one division in all
  const int n = vec ? W >> 2 : W, dr = BW_THREADS / n, dc = BW_THREADS - dr * n;
  int r = threadIdx.x / n, c = threadIdx.x - r * n;
  for (; r < rows; r += dr, c += dc) {
    if (c >= n) {
      c -= n;
      ++r;
      if (r >= rows) break;
    }
    if (vec) {
      const bool ok = r0 + r < rmax && 4 * c < cmax;
      bw_cp16(dst + bw_at(r, 4 * c, W), ok ? src + (size_t)(r0 + r) * sld + 4 * c : src, ok);
    } else {
      const bool ok = r0 + r < rmax && c < cmax;
      bw_cp4(dst + bw_at(r, c, W), ok ? src + (size_t)(r0 + r) * sld + c : src, ok);
    }
  }
}

// Queue copies of l for rows r0 .. r0 + rows - 1 of one head (stride H), 0
// past Q.
__device__ __forceinline__ void bw_stage_l(float* dst, const float* l_h, int H, int r0,
                                           int Q, int rows) {
  for (int r = threadIdx.x; r < rows; r += BW_THREADS) {
    const bool ok = r0 + r < Q;
    bw_cp4(dst + r, ok ? l_h + (size_t)(r0 + r) * H : l_h, ok);
  }
}

// a = hi + lo + O(2^-22 |a|), both TF32: hi = cvt.rna.tf32(a); lo = a - hi
// (exact) rounded to nearest, ties away, by adding half of TF32's last bit:
// the mma reads a TF32 operand's top 19 bits and drops the rest, so this is
// cvt.rna.tf32's rounding of lo without its guard for Inf and NaN, which
// reach lo only where hi is Inf or NaN already.
__device__ __forceinline__ void bw_split(float a, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(a));
  lo = __float_as_uint(a - __uint_as_float(hi)) + 0x1000u;
}

__device__ __forceinline__ void bw_mma(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[j] += a b_j for the n tiles j < NJ, in split TF32: every tile's lo_a
// hi_b, then every hi_a lo_b, then every hi_a hi_b, so that no mma waits on
// the one issued just before it.
template <int NJ>
__device__ __forceinline__ void bw_mma3(float (*acc)[4], const uint32_t ah[4],
                                        const uint32_t al[4], uint32_t bh[4][2],
                                        uint32_t bl[4][2]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) bw_mma(acc[j], al, bh[j]);
#pragma unroll
  for (int j = 0; j < NJ; ++j) bw_mma(acc[j], ah, bl[j]);
#pragma unroll
  for (int j = 0; j < NJ; ++j) bw_mma(acc[j], ah, bh[j]);
}

// Fragments. Lane (g, tig) = (lane / 4, lane % 4). The k slots tig and tig + 4
// of an m16n8k8 step at k0 hold columns k0 + 2 tig and k0 + 2 tig + 1, in A
// and in B alike: the accumulator's own layout, so an accumulator is an A
// operand as it stands.
// A: rows m0 + g and m0 + g + 8 of a row-major tile, k along its columns.
__device__ __forceinline__ void bw_frag_a(const float* A, int W, int m0, int k0, int g,
                                          int tig, uint32_t ah[4], uint32_t al[4]) {
  const float2 x0 = *reinterpret_cast<const float2*>(A + bw_at(m0 + g, k0 + 2 * tig, W));
  const float2 x1 = *reinterpret_cast<const float2*>(A + bw_at(m0 + g + 8, k0 + 2 * tig, W));
  bw_split(x0.x, ah[0], al[0]);
  bw_split(x1.x, ah[1], al[1]);
  bw_split(x0.y, ah[2], al[2]);
  bw_split(x1.y, ah[3], al[3]);
}

// A from an accumulator tile (rows g, g + 8; columns 2 tig, 2 tig + 1).
__device__ __forceinline__ void bw_frag_acc(const float c[4], uint32_t ah[4], uint32_t al[4]) {
  bw_split(c[0], ah[0], al[0]);
  bw_split(c[2], ah[1], al[1]);
  bw_split(c[1], ah[2], al[2]);
  bw_split(c[3], ah[3], al[3]);
}

// B operands come from a streamed tile: with PRE its high parts at T and its
// low parts at T + PL, split once when the tile landed (bw_convert); else
// raw at T, split here.
// B with n along the rows of the tile (k along its columns): row n0 + g.
template <bool PRE>
__device__ __forceinline__ void bw_frag_bt(const float* T, int PL, int W, int n0, int k0,
                                           int g, int tig, uint32_t bh[2], uint32_t bl[2]) {
  const int o = bw_at(n0 + g, k0 + 2 * tig, W);
  const float2 x = *reinterpret_cast<const float2*>(T + o);
  if (PRE) {
    const float2 y = *reinterpret_cast<const float2*>(T + PL + o);
    bh[0] = __float_as_uint(x.x);
    bh[1] = __float_as_uint(x.y);
    bl[0] = __float_as_uint(y.x);
    bl[1] = __float_as_uint(y.y);
  } else {
    bw_split(x.x, bh[0], bl[0]);
    bw_split(x.y, bh[1], bl[1]);
  }
}

// B with k along the rows of the tile: rows k0 + 2 tig and k0 + 2 tig + 1,
// column n0 + g.
template <bool PRE>
__device__ __forceinline__ void bw_frag_b(const float* T, int PL, int W, int k0, int n0,
                                          int g, int tig, uint32_t bh[2], uint32_t bl[2]) {
  const int o0 = bw_at(k0 + 2 * tig, n0 + g, W), o1 = bw_at(k0 + 2 * tig + 1, n0 + g, W);
  if (PRE) {
    bh[0] = __float_as_uint(T[o0]);
    bh[1] = __float_as_uint(T[o1]);
    bl[0] = __float_as_uint(T[PL + o0]);
    bl[1] = __float_as_uint(T[PL + o1]);
  } else {
    bw_split(T[o0], bh[0], bl[0]);
    bw_split(T[o1], bh[1], bl[1]);
  }
}

// The high and low TF32 parts of the n floats at R (n a multiple of 4) to H
// and L.
__device__ __forceinline__ void bw_convert(const float* R, float* H, float* L, int n) {
  for (int i = 4 * threadIdx.x; i < n; i += 4 * BW_THREADS) {
    const float4 v = *reinterpret_cast<const float4*>(R + i);
    uint32_t hi[4], lo[4];
    bw_split(v.x, hi[0], lo[0]);
    bw_split(v.y, hi[1], lo[1]);
    bw_split(v.z, hi[2], lo[2]);
    bw_split(v.w, hi[3], lo[3]);
    *reinterpret_cast<uint4*>(H + i) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(L + i) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// One k step of 8 over the n tiles j < nt of NT (nt a multiple of 4, or
// NT), in groups of 4: a tile past a ragged width is not read. A given; B
// from a tile with n along its rows (KMAJ) or with k along them.
template <int NT, bool KMAJ, bool PRE>
__device__ __forceinline__ void bw_kstep(const uint32_t ah[4], const uint32_t al[4],
                                         const float* T, int PL, int W, int n0, int k0,
                                         int g, int tig, float (*acc)[4], int nt) {
  constexpr int NJ = NT < 4 ? NT : 4;   // n tiles a group (NT is 2 or a multiple of 4)
#pragma unroll
  for (int j0 = 0; j0 < NT; j0 += NJ) {
    if (j0 + NJ <= nt) {
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (KMAJ)
          bw_frag_bt<PRE>(T, PL, W, n0 + 8 * (j0 + j), k0, g, tig, bh[j], bl[j]);
        else
          bw_frag_b<PRE>(T, PL, W, k0, n0 + 8 * (j0 + j), g, tig, bh[j], bl[j]);
      }
      bw_mma3<NJ>(acc + j0, ah, al, bh, bl);
    }
  }
}

// acc[j] += A[m0.., a_k0 + k] T[n0 + 8j.., k] over k < K (a multiple of 32),
// j < NT: A raw, T a streamed tile with n along its rows.
template <int NT, bool PRE>
__device__ __forceinline__ void bw_mm_nt(const float* A, int Wa, int m0, int a_k0,
                                         const float* T, int PL, int W, int n0, int K,
                                         int g, int tig, float (*acc)[4]) {
#pragma unroll 1
  for (int k = 0; k < K; k += 8) {
    uint32_t ah[4], al[4];
    bw_frag_a(A, Wa, m0, a_k0 + k, g, tig, ah, al);
    bw_kstep<NT, true, PRE>(ah, al, T, PL, W, n0, k, g, tig, acc, NT);
  }
}

// acc[j] += A[m0.., a_k0 + k] T[k, n0 + 8j..] over k < BW_U, j < nt (nt a
// multiple of 4, or NT): A raw, T a streamed tile with k along its rows.
template <int NT, bool PRE>
__device__ __forceinline__ void bw_mm_nn(const float* A, int Wa, int m0, int a_k0,
                                         const float* T, int PL, int W, int n0, int g,
                                         int tig, float (*acc)[4], int nt) {
#pragma unroll 1
  for (int k = 0; k < BW_U; k += 8) {
    uint32_t ah[4], al[4];
    bw_frag_a(A, Wa, m0, a_k0 + k, g, tig, ah, al);
    bw_kstep<NT, false, PRE>(ah, al, T, PL, W, n0, k, g, tig, acc, nt);
  }
}

// acc[j] += a[ks] T[b_k0 + 8 ks.., n0 + 8j..] over ks < KS (a: the
// accumulator tiles of a 16-row product, each 8 columns of k), j < nt (nt
// a multiple of 4, or NT). The k steps run as a loop (a[ks] picked by
// selects), which keeps the code small.
template <int KS, int NT, bool PRE>
__device__ __forceinline__ void bw_mm_rn(float (*a)[4], const float* T, int PL, int W,
                                         int b_k0, int n0, int g, int tig, float (*acc)[4],
                                         int nt) {
#pragma unroll 1
  for (int ks = 0; ks < KS; ++ks) {
    float c[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      c[q] = a[0][q];
#pragma unroll
      for (int r = 1; r < KS; ++r) c[q] = ks == r ? a[r][q] : c[q];
    }
    uint32_t ah[4], al[4];
    bw_frag_acc(c, ah, al);
    bw_kstep<NT, false, PRE>(ah, al, T, PL, W, n0, b_k0 + 8 * ks, g, tig, acc, nt);
  }
}

// An accumulator tile to / from a swizzled shared tile W wide (rows m0 + g
// and m0 + g + 8, columns c0 + 2 tig and c0 + 2 tig + 1).
__device__ __forceinline__ void bw_put(float* T, int W, int m0, int c0, int g, int tig,
                                       const float c[4]) {
  *reinterpret_cast<float2*>(T + bw_at(m0 + g, c0 + 2 * tig, W)) = make_float2(c[0], c[1]);
  *reinterpret_cast<float2*>(T + bw_at(m0 + g + 8, c0 + 2 * tig, W)) = make_float2(c[2], c[3]);
}

__device__ __forceinline__ float bw_get(const float* T, int W, int m0, int c0, int g,
                                        int tig, int q) {
  return T[bw_at(m0 + g + 8 * (q >> 1), c0 + 2 * tig + (q & 1), W)];
}

// Row r's values v[q] (q = 0, 1: columns col, col + 1) to global row `out`,
// within `lim` columns; a float2 store when both fit and the pair is aligned.
__device__ __forceinline__ void bw_store2(float* out, int col, int lim, float v0, float v1) {
  if (col + 1 < lim && ((reinterpret_cast<uintptr_t>(out + col) & 7) == 0)) {
    *reinterpret_cast<float2*>(out + col) = make_float2(v0, v1);
  } else {
    if (col < lim) out[col] = v0;
    if (col + 1 < lim) out[col + 1] = v1;
  }
}

// Shared memory, in floats: the block's own tiles (SL: an s block's 64 rows
// of B and xw, a t block's 128 rows of dy), the streamed 32-row tiles (SU =
// 32 (WN + WP) each: with PRE a landing slot and the high and low planes,
// else two slots when `ahead`, else one), then 64 x 32 for dM^T (at d_off)
// and BW_SMALL.
template <int OWP, int OWN, int MINB, bool PRE>
__global__ void __launch_bounds__(BW_THREADS, MINB)
ssd_intra_bwd_kernel(const float* __restrict__ xw, const float* __restrict__ Bm,
                     const float* __restrict__ Cm, const float* __restrict__ l,
                     const float* __restrict__ dy, const float* __restrict__ dS,
                     float* __restrict__ dxw, float* __restrict__ dBh,
                     float* __restrict__ dCh, float* __restrict__ colG,
                     float* __restrict__ rowGp, float* __restrict__ upart,
                     float* __restrict__ usum, int BC, int Q, int H, int P, int G, int N,
                     int WP, int WN, int n_tt, int n_so, int n_pc, int n_nc, int ahead,
                     int d_off) {
  constexpr int MT = (OWP > OWN ? OWP : OWN) / 8;  // n tiles of an output row
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  // one head's blocks run side by side (its xw and dy stay in L2), the
  // heaviest first: the s tiles from the first, then the t tiles from the last
  const int items = n_tt * n_so + (n_tt + 1) / 2 * n_nc;
  const int bh = (int)(blockIdx.x / items), item = (int)(blockIdx.x - (unsigned)bh * items);
  const int bc = bh / H, h = bh - bc * H;
  const int grp = h / (H / G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int m0 = 16 * (warp & 3);       // the warp's 16 rows of the block's tile
  const int n_tu = (Q + BW_U - 1) / BW_U;
  const int SU = BW_U * (WN + WP);
  const int SL = max(BW_T * (WN + WP), 2 * BW_T * WP);  // the block's own tiles
  float* D = sm + d_off;
  float* red = D + BW_T * BW_U;         // 4 x 32: column sums of G by warp
  float* l_own = red + 4 * BW_U;        // 128: l of the block's own rows
  float* l_str = l_own + 2 * BW_T;      // 2 x 32: l of the streamed rows, by parity
  // where the streamed tile i lands, and where the products read it: with PRE
  // one landing slot, then its high and low planes
  auto slot = [&](int i) { return sm + SL + (!PRE && ahead ? (i & 1) * SU : 0); };
  float* const Hp = sm + SL + SU;
  auto comp = [&](int i) { return PRE ? (const float*)Hp : (const float*)slot(i); };
  auto landed = [&](int i) {            // the tile in slot(i) is whole: split it
    if (PRE) {
      bw_convert(slot(i), Hp, Hp + SU, SU);
      __syncthreads();
    }
  };

  const size_t x_ld = (size_t)H * P, b_ld = (size_t)G * N;
  const size_t bcqh = (size_t)BC * Q * H;
  const float* x_h = xw + (size_t)bc * Q * x_ld + (size_t)h * P;
  const float* dy_h = dy + (size_t)bc * Q * x_ld + (size_t)h * P;
  const float* b_g = Bm + (size_t)bc * Q * b_ld + (size_t)grp * N;
  const float* c_g = Cm + (size_t)bc * Q * b_ld + (size_t)grp * N;
  const float* l_h = l + (size_t)bc * Q * H + h;
  const float* dS_h = dS + ((size_t)bc * H + h) * N * P;
  const bool vec_x = (P & 3) == 0, vec_b = (N & 3) == 0;
  auto l_at = [&](int r) { return r < Q ? __ldg(l_h + (size_t)r * H) : 0.f; };
  if (item < n_tt * n_so)
    bw_stage_l(l_own, l_h, H, item / n_so * BW_T, Q, BW_T);
  else
    bw_stage_l(l_own, l_h, H, ((n_tt + 1) / 2 - 1 - (item - n_tt * n_so) / n_nc) * 2 * BW_T, Q,
               2 * BW_T);

  if (item < n_tt * n_so) {
    // ---- an s block: rows s0.., output slice jo of dxw (p) and dB (n). Warps
    // 0-3 (role 0) form (C B^T)^T, M^T and dxw; warps 4-7 (role 1) (dy
    // xw^T)^T, (dM E)^T and dB; 16 rows s each, every column t ----
    const int is = item / n_so, jo = item % n_so;
    const int s0 = is * BW_T, role = warp >> 2;
    const bool has_p = jo < n_pc, has_n = jo < n_nc, lead = jo == 0;
    const bool active = role == 0 ? has_p || lead : has_n || lead;
    const bool has_out = role == 0 ? has_p : has_n;
    const int p0 = jo * OWP, n0 = jo * OWN;
    const int ntp = has_p ? min(OWP, WP - p0) / 8 : 0;
    const int ntn = has_n ? min(OWN, WN - n0) / 8 : 0;
    float* bs = sm;                     // 64 x WN: B rows of the s tile
    float* xs = bs + BW_T * WN;         // 64 x WP: xw rows of the s tile
    bw_stage(bs, WN, b_g, b_ld, s0, Q, N, vec_b);
    bw_stage(xs, WP, x_h, x_ld, s0, Q, P, vec_x);
    auto fetch = [&](int iu, float* dst) {
      bw_stage(dst, WN, c_g, b_ld, iu * BW_U, Q, N, vec_b, BW_U);
      bw_stage(dst + BW_U * WN, WP, dy_h, x_ld, iu * BW_U, Q, P, vec_x, BW_U);
      bw_stage_l(l_str + (iu & 1) * BW_U, l_h, H, iu * BW_U, Q, BW_U);
    };
    const int iu0 = 2 * is;             // the first streamed tile: t = s0
    // the chunks of dS for the state terms, two deep where a slot is free:
    // chunk k lands in post(k), the first during the last t tile (with PRE
    // each lands where the t tiles did and is split into the planes)
    const bool pipe = PRE || ahead;
    auto post = [&](int k) { return slot(PRE ? 0 : n_tu - iu0 + (ahead ? k : 0)); };
    auto fetch_ds = [&](int k) {
      bw_stage(post(k), WP, dS_h, P, k * BW_U, N, P, vec_x, BW_U);
    };
    if (ahead) fetch(iu0, slot(0));
    bw_commit();
    // role 0: A = B_s, then the streamed C as B^T, then dy as B; role 1:
    // A = xw_s, dy, then C
    const float* A = role == 0 ? bs : xs;
    const int Wa = role == 0 ? WN : WP;
    float acc[4][4], out[MT][4] = {};
    float gs[2] = {0.f, 0.f};           // role 0, rows g, g + 8: sums of G over t
    for (int iu = iu0; iu < n_tu; ++iu) {
      const int i = iu - iu0;
      if (!ahead) {
        fetch(iu, slot(i));
        bw_commit();
      }
      bw_wait_all();
      __syncthreads();                  // tile iu has landed; tile iu - 1 is done with
      landed(i);
      if (ahead && iu + 1 < n_tu) {
        fetch(iu + 1, slot(i + 1));
        bw_commit();
      } else if (pipe && iu + 1 == n_tu) {
        fetch_ds(0);
        bw_commit();
      }
      const float ls[2] = {l_own[m0 + g], l_own[m0 + g + 8]};
      const float* lt2 = l_str + (iu & 1) * BW_U;
      if (lead && i > 0 && tid < BW_U && (iu - 1) * BW_U + tid < Q)
        rowGp[(size_t)is * bcqh + ((size_t)bc * Q + (iu - 1) * BW_U + tid) * H + h] =
            red[tid] + red[BW_U + tid] + red[2 * BW_U + tid] + red[3 * BW_U + tid];
      const float* cs = comp(i);        // 32 x WN: C rows of the t tile
      const float* ds = cs + BW_U * WN; // 32 x WP: dy rows of the t tile
      const int t0 = iu * BW_U;
      // the live 8-column tiles of t: none wholly before the warp's rows s,
      // none wholly past Q
      const int jlo = max(0, (s0 + m0 - t0) / 8), jhi = min(4, (Q - t0 + 7) / 8);
      const bool live = active && s0 + m0 < Q && jlo < jhi;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
      if (live)                         // (C B^T)^T or (dy xw^T)^T: rows s, columns t
        bw_mm_nt<4, PRE>(A, Wa, m0, 0, role == 0 ? cs : ds, SU, Wa, 0, Wa, g, tig, acc);
      if (lead && role == 1) {          // dM^T for G: role 1 hands it over, role 0 waits
#pragma unroll
        for (int j = 0; j < 4; ++j) bw_put(D, BW_U, m0, 8 * j, g, tig, acc[j]);
        asm volatile("bar.arrive 1, %0;\n" ::"n"(BW_THREADS) : "memory");
      }
      if (live) {                       // M^T = (C B^T)^T E^T, (dM E)^T = dM^T E^T
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const int t = t0 + 8 * j + 2 * tig + b;
            const float lt = lt2[8 * j + 2 * tig + b];
#pragma unroll
            for (int k = 0; k < 2; ++k)
              acc[j][2 * k + b] *=
                  s0 + m0 + g + 8 * k <= t && t < Q ? expf(lt - ls[k]) : 0.f;
          }
        }
      }
      if (lead && role == 0) asm volatile("bar.sync 1, %0;\n" ::"n"(BW_THREADS) : "memory");
      if (lead && role == 0) {          // G = dM M: its sums over t and over s
        float gc[4][2] = {};
        if (live) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float gv = acc[j][q] * bw_get(D, BW_U, m0, 8 * j, g, tig, q);
              gs[q >> 1] += gv;
              gc[j][q & 1] += gv;
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            float v = gc[j][b];
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            if (g == 0) red[warp * BW_U + 8 * j + 2 * tig + b] = v;
          }
        }
      }
      if (live && has_out) {            // dxw += M^T dy  or  dB += (dM E)^T C
        bw_mm_rn<4, MT, PRE>(acc, role == 0 ? ds : cs, SU, role == 0 ? WP : WN, 0,
                             role == 0 ? p0 : n0, g, tig, out, role == 0 ? ntp : ntn);
      }
      if (!ahead) __syncthreads();
    }
    const float ls[2] = {l_own[m0 + g], l_own[m0 + g + 8]};
    const float l_end = l_at(Q - 1);
    const float w[2] = {s0 + m0 + g < Q ? expf(l_end - ls[0]) : 0.f,
                        s0 + m0 + g + 8 < Q ? expf(l_end - ls[1]) : 0.f};
    // the state terms from dS in 32-row chunks: Z = B_s dS[:, p slice] (role
    // 0), V = xw_s dS[n slice, :]^T (role 1)
    float st[MT][4] = {};
    for (int k = 0, c = 0; c < WN; ++k, c += BW_U) {
      if (!pipe) {
        fetch_ds(k);
        bw_commit();
      }
      bw_wait_all();
      __syncthreads();                  // chunk k has landed; the slot before is free
      if (PRE) {
        bw_convert(post(k), Hp, Hp + SU, BW_U * WP);
        __syncthreads();
      }
      if (pipe && c + BW_U < WN) {
        fetch_ds(k + 1);
        bw_commit();
      }
      const float* ch = PRE ? Hp : post(k);  // 32 x WP: rows c.. of dS
      if (role == 0 && has_p)
        bw_mm_nn<OWP / 8, PRE>(bs, WN, m0, c, ch, SU, WP, p0, g, tig, st, ntp);
      if (role == 1 && has_n) {
#pragma unroll
        for (int q = 0; q < OWN / 32; ++q)
          if (c == n0 + 32 * q)
            bw_mm_nt<4, PRE>(xs, WP, m0, 0, ch, SU, WP, 0, WP, g, tig, st + 4 * q);
      }
      if (!pipe) __syncthreads();
    }
    if (lead && tid < BW_U && (n_tu - 1) * BW_U + tid < Q)   // the last t tile's sums
      rowGp[(size_t)is * bcqh + ((size_t)bc * Q + (n_tu - 1) * BW_U + tid) * H + h] =
          red[tid] + red[BW_U + tid] + red[2 * BW_U + tid] + red[3 * BW_U + tid];
    float* usm = D;                     // 64: u_s
    if (role == 0) {                    // dxw = M^T dy + w Z;  u_s;  dl's column sums
      float u[2] = {0.f, 0.f};
      if (has_p) {
#pragma unroll
        for (int j = 0; j < MT; ++j) {
          if (j >= ntp) continue;
          float v[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int row = m0 + g + 8 * (q >> 1);
            const float z = w[q >> 1] * st[j][q];
            v[q] = out[j][q] + z;
            u[q >> 1] = fmaf(xs[bw_at(row, p0 + 8 * j + 2 * tig + (q & 1), WP)], z, u[q >> 1]);
          }
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int s = s0 + m0 + g + 8 * k;
            if (s < Q)
              bw_store2(dxw + ((size_t)bc * Q + s) * x_ld + (size_t)h * P,
                        p0 + 8 * j + 2 * tig, P, v[2 * k], v[2 * k + 1]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        u[k] += __shfl_xor_sync(0xffffffffu, u[k], 1);
        u[k] += __shfl_xor_sync(0xffffffffu, u[k], 2);
        gs[k] += __shfl_xor_sync(0xffffffffu, gs[k], 1);
        gs[k] += __shfl_xor_sync(0xffffffffu, gs[k], 2);
        const int row = m0 + g + 8 * k;
        if (tig == 0) {
          usm[row] = u[k];
          if (lead && s0 + row < Q) colG[((size_t)bc * Q + s0 + row) * H + h] = gs[k];
        }
      }
    } else if (has_n) {                 // dB = (dM E)^T C + w V
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        if (j >= ntn) continue;
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = fmaf(w[q >> 1], st[j][q], out[j][q]);
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int s = s0 + m0 + g + 8 * k;
          if (s < Q)
            bw_store2(dBh + (((size_t)bc * Q + s) * H + h) * N, n0 + 8 * j + 2 * tig, N,
                      v[2 * k], v[2 * k + 1]);
        }
      }
    }
    if (has_p) {
      __syncthreads();                  // u_s is whole
      if (tid < BW_T && s0 + tid < Q)
        upart[(size_t)jo * bcqh + ((size_t)bc * Q + s0 + tid) * H + h] = usm[tid];
      if (warp == 0) {                  // the sum of u_s over the tile, a fixed tree
        float su = usm[lane] + usm[lane + 32];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) su += __shfl_xor_sync(0xffffffffu, su, o);
        if (lane == 0) usum[(((size_t)bc * H + h) * n_tt + is) * n_pc + jo] = su;
      }
    }
    return;
  }

  // ---- a t block: 128 rows t0.., output slice jn of dC. Warp: 16 rows t,
  // every column s of each 32-row s tile ----
  const int yy = item - n_tt * n_so, n_t2 = (n_tt + 1) / 2;
  const int it = n_t2 - 1 - yy / n_nc, jn = yy % n_nc;  // heaviest tile first
  const int t0 = it * 2 * BW_T, n0 = jn * OWN, mt = 16 * warp;
  const int ntn = min(OWN, WN - n0) / 8;
  const int iu_end = min(n_tu, (t0 + 2 * BW_T) / BW_U);  // the s tiles up to the last row
  float* dt = sm;                       // 128 x WP: dy rows of the t tile
  bw_stage(dt, WP, dy_h, x_ld, t0, Q, P, vec_x, 2 * BW_T);
  auto fetch = [&](int iu, float* dst) {
    bw_stage(dst, WN, b_g, b_ld, iu * BW_U, Q, N, vec_b, BW_U);
    bw_stage(dst + BW_U * WN, WP, x_h, x_ld, iu * BW_U, Q, P, vec_x, BW_U);
    bw_stage_l(l_str + (iu & 1) * BW_U, l_h, H, iu * BW_U, Q, BW_U);
  };
  if (ahead) fetch(0, slot(0));
  bw_commit();
  float acc[4][4], out[MT][4] = {};
  for (int iu = 0; iu < iu_end; ++iu) {
    if (!ahead) {
      fetch(iu, slot(iu));
      bw_commit();
    }
    bw_wait_all();
    __syncthreads();
    landed(iu);
    if (ahead && iu + 1 < iu_end) {
      fetch(iu + 1, slot(iu + 1));
      bw_commit();
    }
    const float* bs = comp(iu);         // 32 x WN: B rows of the s tile
    const float* xs = bs + BW_U * WN;   // 32 x WP: xw rows of the s tile
    const int s0 = iu * BW_U;
    const float lt[2] = {l_own[mt + g], l_own[mt + g + 8]};
    const float* ls2 = l_str + (iu & 1) * BW_U;
    // a warp whose rows are all before the s tile, or past Q, does nothing
    if (t0 + mt < Q && s0 <= t0 + mt + 15) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
      bw_mm_nt<4, PRE>(dt, WP, mt, 0, xs, SU, WP, 0, WP, g, tig, acc);  // dy xw^T
#pragma unroll
      for (int j = 0; j < 4; ++j) {     // dM E
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int s = s0 + 8 * j + 2 * tig + b;
          const float ls = ls2[8 * j + 2 * tig + b];
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int t = t0 + mt + g + 8 * k;
            acc[j][2 * k + b] *= s <= t && t < Q ? expf(lt[k] - ls) : 0.f;
          }
        }
      }
      bw_mm_rn<4, OWN / 8, PRE>(acc, bs, SU, WN, 0, n0, g, tig, out, ntn);  // (dM E) B
    }
    if (!ahead) __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < OWN / 8; ++j) {
    if (j >= ntn) continue;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int t = t0 + mt + g + 8 * k;
      if (t < Q)
        bw_store2(dCh + (((size_t)bc * Q + t) * H + h) * N, n0 + 8 * j + 2 * tig, N,
                  out[j][2 * k], out[j][2 * k + 1]);
    }
  }
}

// The fixed-order sums. Threads [0, BC*Q*G*N): dB and dC of one (bc, q, g, n)
// over the group's heads in ascending order. Threads past them: dl of one
// (bc, q, h) = the column sums of G over s tiles 0 .. q / 64 in ascending
// order - its row sum - u_q (the sum of its p slices), and at q = Q - 1 +
// the sum of u over s tiles, then p slices, in ascending order.
__global__ void ssd_bwd_reduce_kernel(const float* __restrict__ dBh,
                                      const float* __restrict__ dCh,
                                      const float* __restrict__ colG,
                                      const float* __restrict__ rowGp,
                                      const float* __restrict__ upart,
                                      const float* __restrict__ usum,
                                      float* __restrict__ dB, float* __restrict__ dC,
                                      float* __restrict__ dl, int BC, int Q, int H,
                                      int G, int N, int n_tt, int n_pc) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n_bcn = (long long)BC * Q * G * N;
  const int rep = H / G;
  if (i < n_bcn) {
    const int n = (int)(i % N);
    const long long r = i / N;
    const int g = (int)(r % G);
    const long long bq = r / G;
    const float* b = dBh + (bq * H + (long long)g * rep) * N + n;
    const float* c = dCh + (bq * H + (long long)g * rep) * N + n;
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < rep; ++k) {
      sb += b[(size_t)k * N];
      sc += c[(size_t)k * N];
    }
    dB[i] = sb;
    dC[i] = sc;
    return;
  }
  const long long at = i - n_bcn;       // ((bc * Q) + q) * H + h
  const long long bcqh = (long long)BC * Q * H;
  if (at >= bcqh) return;
  const int h = (int)(at % H);
  const long long bq = at / H;
  const int q = (int)(bq % Q), bc = (int)(bq / Q);
  float rg = 0.f;
  for (int is = 0; is <= q / BW_T; ++is) rg += rowGp[is * bcqh + at];
  float u = 0.f;
  for (int k = 0; k < n_pc; ++k) u += upart[k * bcqh + at];
  float v = rg - colG[at] - u;
  if (q == Q - 1) {
    const float* us = usum + ((size_t)bc * H + h) * n_tt * n_pc;
    float su = 0.f;
    for (int k = 0; k < n_tt * n_pc; ++k) su += us[k];
    v += su;
  }
  dl[at] = v;
}

template <int OWP, int OWN, int MINB, bool PRE>
static cudaError_t bw_launch(dim3 grid, size_t smem, cudaStream_t s, const float* xw,
                             const float* Bm, const float* Cm, const float* l,
                             const float* dy, const float* dS, float* dxw, float* dBh,
                             float* dCh, float* colG, float* rowGp, float* upart,
                             float* usum, int BC, int Q, int H, int P, int G, int N,
                             int WP, int WN, int n_tt, int n_so, int n_pc, int n_nc,
                             int ahead, int d_off) {
  auto kernel = ssd_intra_bwd_kernel<OWP, OWN, MINB, PRE>;
  cudaError_t err = l2s_allow_smem(kernel, smem);
  if (err == cudaSuccess && MINB > 1)   // all of the SM's shared memory, for MINB blocks
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<grid, BW_THREADS, smem, s>>>(xw, Bm, Cm, l, dy, dS, dxw, dBh, dCh, colG, rowGp,
                                        upart, usum, BC, Q, H, P, G, N, WP, WN, n_tt, n_so,
                                        n_pc, n_nc, ahead, d_off);
  return cudaGetLastError();
}

// xw, dy (BC, Q, H, P); Bm, Cm (BC, Q, G, N); l (BC, Q, H); dS (BC, H, N, P)
// -> dxw (BC, Q, H, P), dB, dC (BC, Q, G, N), dl (BC, Q, H); all float32,
// contiguous, 16-byte aligned, on one device; BC = batch * chunks; G divides
// H. scratch holds BC*Q*H*(2N + 1 + n_tt + n_pc) + BC*H*n_tt*n_pc floats,
// n_tt = ceil(Q / 64), n_pc the output slices of P (1 up to P = 128, else
// ceil(P / 128)) (kernels/ssd.py::bwd_scratch_floats): the per-head dB and dC,
// the row sums of G, its column sums per s tile, u_s per p slice and the sum
// of u per s tile and p slice. Two launches on the current stream. Returns a
// cudaError_t (0 on success); a shape the grid or shared memory cannot hold
// is refused with cudaErrorInvalidValue.
extern "C" int l2s_ssd_intra_bwd(const float* xw, const float* Bm, const float* Cm,
                                 const float* l, const float* dy, const float* dS,
                                 float* dxw, float* dB, float* dC, float* dl,
                                 float* scratch, int BC, int Q, int H, int P, int G,
                                 int N, void* stream) {
  if (BC <= 0 || Q <= 0 || H <= 0) return (int)cudaSuccess;
  if (G <= 0 || H % G || P <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const int n_tt = (Q + BW_T - 1) / BW_T;
  // output slices 64 or 128 wide (no <128, 64> body: its n tiles run
  // masked in <128, 128>)
  int owp = P > 64 ? 128 : 64, own = N > 64 ? 128 : 64;
  if (owp == 128) own = 128;
  const int n_pc = (P + owp - 1) / owp, n_nc = (N + own - 1) / own;
  const int n_so = n_pc > n_nc ? n_pc : n_nc;
  const long long blocks = ((long long)n_tt * n_so + (n_tt + 1) / 2 * n_nc) * BC * H;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t WP = (size_t)(P + 31) & ~(size_t)31, WN = (size_t)(N + 31) & ~(size_t)31;
  const size_t SU = BW_U * (WN + WP);
  const size_t SL = BW_T * (WN + WP) > 2 * BW_T * WP ? BW_T * (WN + WP) : 2 * BW_T * WP;
  const size_t fixed = SL + BW_T * BW_U + BW_SMALL;
  const size_t limit = 227 * 1024 / sizeof(float);
  // N, P <= 64: a landing slot and the split planes (3 SU); else two slots
  // where they fit, else one
  const bool pre = owp == 64 && own == 64;
  size_t ring = (pre ? 3 : 2) * SU;
  const int ahead = fixed + ring <= limit;
  if (!ahead) ring = SU;
  if (fixed + ring > limit) return (int)cudaErrorInvalidValue;
  const int d_off = (int)(SL + ring);
  const size_t smem = (fixed + ring) * sizeof(float);
  const size_t bcqh = (size_t)BC * Q * H;
  float* dBh = scratch;
  float* dCh = dBh + bcqh * N;
  float* colG = dCh + bcqh * N;
  float* rowGp = colG + bcqh;
  float* upart = rowGp + bcqh * n_tt;
  float* usum = upart + bcqh * n_pc;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)blocks);
#define BW_ARGS                                                                        \
  grid, smem, s, xw, Bm, Cm, l, dy, dS, dxw, dBh, dCh, colG, rowGp, upart, usum, BC, Q, \
      H, P, G, N, (int)WP, (int)WN, n_tt, n_so, n_pc, n_nc, ahead, d_off
  cudaError_t err;
  if (owp == 128)
    err = bw_launch<128, 128, 1, false>(BW_ARGS);
  else if (own == 128)                  // two blocks an SM: 128 registers
    err = bw_launch<64, 128, 2, false>(BW_ARGS);
  else
    err = bw_launch<64, 64, 2, true>(BW_ARGS);
#undef BW_ARGS
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)BC * Q * G * N + (long long)bcqh;
  const int threads = 256;
  const long long rblocks = (total + threads - 1) / threads;
  if (rblocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ssd_bwd_reduce_kernel<<<(unsigned)rblocks, threads, 0, s>>>(
      dBh, dCh, colG, rowGp, upart, usum, dB, dC, dl, BC, Q, H, G, N, n_tt, n_pc);
  return (int)cudaGetLastError();
}

