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
// xw dS^T: 4 Q N P; u_s reuses xw dS^T). At zamba2-2.7b's prefill shape (B = 4,
// T = 512: nc = 2, Q = 256, H = 80, P = N = 64) that is 1.615e10 float32 flops,
// 0.241 ms at 67 TFLOP/s, against 1.4e8 bytes of inputs and outputs (0.042 ms
// at 3.35 TB/s). IEEE float32 throughout (no TF32, no fast-math exp), on the
// FMA units, as the forward.
//
// Design: simple first. 128 threads (4 warps) a block, each warp a 32 x 32
// quarter of a 64 x 64 tile and each thread an 8 x 4 register micro-tile, read
// with 128-bit shared loads, as in ssd.cu; tiles are staged with plain loads
// (no cp.async ring). Two kinds of block over a grid x = batch*chunk x head:
//   * an s block owns 64 rows s and, for each t tile at or after its own,
//     recomputes C B^T and xw dy^T (transposed: rows s, columns t), forms M^T
//     and (dM E)^T in shared memory, and accumulates dxw_s = M^T dy and the
//     head's dB_s = (dM E)^T C; the row sums of G over t give its part of dl.
//     Then the state terms: (B dS) w into dxw, (xw dS^T) w into dB and u_s.
//     For P or N > 64 an s block owns one 64-wide slice of each.
//   * a t block owns 64 rows t and, for each s tile up to its own,
//     recomputes dy xw^T (and C B^T for the row sums of G) and accumulates the
//     head's dC_t = (dM E) B; one block per 64-wide slice of N.
// So the kernel runs seven 64 x 64 x 64 products per causal tile pair where
// the bound counts five; a warp whose quarter of a diagonal tile lies wholly
// past the causal edge skips its products. No atomics: each head's dB and dC
// and each block's part of dl go to scratch, and a second kernel sums them in
// a fixed order (dB and dC over the heads of a group in ascending head order,
// dl as rows - columns - u, then the sum of u in ascending s at row Q - 1).
// Two launches on the same inputs give the same bits.
#include "l2s_common.cuh"

#define BW_T 64          // rows of a tile; width of an output slice
#define BW_THREADS 128   // 4 warps: a 32 x 32 quarter each, 8 x 4 per thread
#define BW_LDM 72        // row stride of the M^T / (dM E)^T tiles

__device__ __forceinline__ float4 bw_ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// dst[r * dld + c] = src[(r0 + r) * sld + c] for r < 64, c < cols (a multiple
// of 4); 0 where r0 + r >= rmax or c >= cmax. 16-byte loads when vec (cmax,
// sld and src all multiples of 4 floats).
__device__ __forceinline__ void bw_stage(float* dst, int dld, const float* src,
                                         size_t sld, int r0, int rmax, int cols,
                                         int cmax, bool vec) {
  if (vec) {
    const int c4 = cols >> 2;
    for (int i = threadIdx.x; i < BW_T * c4; i += BW_THREADS) {
      const int r = i / c4, c = (i - r * c4) << 2;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r0 + r < rmax && c < cmax)
        v = __ldg(reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * sld + c));
      *reinterpret_cast<float4*>(dst + r * dld + c) = v;
    }
  } else {
    for (int i = threadIdx.x; i < BW_T * cols; i += BW_THREADS) {
      const int r = i / cols, c = i - r * cols;
      dst[r * dld + c] =
          (r0 + r < rmax && c < cmax) ? __ldg(src + (size_t)(r0 + r) * sld + c) : 0.f;
    }
  }
}

// dst[p * dld + n] = src[(n0 + n) * sld + p0 + p] for n, p < 64; 0 where
// n0 + n >= nmax or p0 + p >= pmax (a transposed slice of dS).
__device__ __forceinline__ void bw_stage_t(float* dst, int dld, const float* src,
                                           int sld, int n0, int nmax, int p0,
                                           int pmax) {
  for (int i = threadIdx.x; i < BW_T * BW_T; i += BW_THREADS) {
    const int n = i / BW_T, p = i - n * BW_T;
    dst[p * dld + n] = (n0 + n < nmax && p0 + p < pmax)
                           ? __ldg(src + (size_t)(n0 + n) * sld + p0 + p) : 0.f;
  }
}

// l for rows r0 .. r0 + 63 of one head (stride H), 0 past Q.
__device__ __forceinline__ void bw_stage_l(float* dst, const float* l_h, int H,
                                           int r0, int Q) {
  for (int r = threadIdx.x; r < BW_T; r += BW_THREADS)
    dst[r] = r0 + r < Q ? __ldg(l_h + (size_t)(r0 + r) * H) : 0.f;
}

// acc[i][j] += sum_k A[r0 + ly + 4i][k] * Bt[c0 + lx + 8j][k], k < K4 (a
// multiple of 4): a product of two row-major tiles whose k runs along rows.
__device__ __forceinline__ void bw_mm_nt(const float* A, int lda, const float* Bt,
                                         int ldb, int K4, int r0, int c0, int ly,
                                         int lx, float acc[8][4]) {
  const float* a_row = A + (r0 + ly) * lda;
  const float* b_row = Bt + (c0 + lx) * ldb;
  for (int k = 0; k < K4; k += 4) {
    float4 a[8], b[4];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = bw_ld4(a_row + 4 * i * lda + k);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = bw_ld4(b_row + 8 * j * ldb + k);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
    }
  }
}

#define BW_FMA4(acc, a, b)           \
  acc[0] = fmaf(a, (b).x, acc[0]);   \
  acc[1] = fmaf(a, (b).y, acc[1]);   \
  acc[2] = fmaf(a, (b).z, acc[2]);   \
  acc[3] = fmaf(a, (b).w, acc[3]);

// acc[i][q] += sum_k A[r0 + ly + 4i][k] * Bm[k][c0 + 4lx + q], k < 64: A's
// k runs along its rows, Bm's down its columns.
__device__ __forceinline__ void bw_mm_nn(const float* A, int lda, const float* Bm,
                                         int ldb, int r0, int c0, int ly, int lx,
                                         float acc[8][4]) {
  const float* a_row = A + (r0 + ly) * lda;
  const float* b_col = Bm + c0 + 4 * lx;
  for (int k = 0; k < BW_T; k += 4) {
    float4 m[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) m[i] = bw_ld4(a_row + 4 * i * lda + k);
    const float4 x0 = bw_ld4(b_col + k * ldb);
    const float4 x1 = bw_ld4(b_col + (k + 1) * ldb);
    const float4 x2 = bw_ld4(b_col + (k + 2) * ldb);
    const float4 x3 = bw_ld4(b_col + (k + 3) * ldb);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      BW_FMA4(acc[i], m[i].x, x0)
      BW_FMA4(acc[i], m[i].y, x1)
      BW_FMA4(acc[i], m[i].z, x2)
      BW_FMA4(acc[i], m[i].w, x3)
    }
  }
}

// The sum of v over the 8 lanes lx = 0..7 that share ly (xor 4, 2, 1: the
// same tree in every call), left in every one of them.
__device__ __forceinline__ float bw_sum8(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v;
}

// Row sums of a warp quarter (part[i]: this thread's share of row r0 + ly +
// 4i) into red[(c0 / 32) * 64 + row]; the caller syncs, then row r's sum over
// the tile's 64 columns is red[r] + red[64 + r].
__device__ __forceinline__ void bw_row_sums(float part[8], float* red, int r0,
                                            int c0, int ly, int lx) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float v = bw_sum8(part[i]);
    if (lx == 0) red[(c0 >> 5) * BW_T + r0 + ly + 4 * i] = v;
  }
}

__global__ void __launch_bounds__(BW_THREADS)
ssd_intra_bwd_kernel(const float* __restrict__ xw, const float* __restrict__ Bm,
                     const float* __restrict__ Cm, const float* __restrict__ l,
                     const float* __restrict__ dy, const float* __restrict__ dS,
                     float* __restrict__ dxw, float* __restrict__ dBh,
                     float* __restrict__ dCh, float* __restrict__ rowG,
                     float* __restrict__ colG, float* __restrict__ upart, int Q,
                     int H, int P, int G, int N, int n_tt, int n_so, int n_pc,
                     int n_nc) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int bc = blockIdx.x / H, h = blockIdx.x - bc * H;
  const int g = h / (H / G);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ly = lane >> 3, lx = lane & 7;
  const int r0 = (warp >> 1) * 32, c0 = (warp & 1) * 32;  // the warp's quarter
  const int tid = threadIdx.x;

  const int N4 = (N + 3) & ~3, P4 = (P + 3) & ~3;
  const int ldn = n_nc * BW_T + 4, ldp = n_pc * BW_T + 4;
  float* bs = sm;                       // 64 x ldn: B rows of an s tile
  float* xs = bs + BW_T * ldn;          // 64 x ldp: xw rows of an s tile
  float* cs = xs + BW_T * ldp;          // 64 x ldn: C rows of a t tile
  float* ds = cs + BW_T * ldn;          // 64 x ldp: dy rows of a t tile
  float* mt = ds + BW_T * ldp;          // 64 x BW_LDM: M (or M^T)
  float* dt = mt + BW_T * BW_LDM;       // 64 x BW_LDM: dM E (or its transpose)
  float* ls = dt + BW_T * BW_LDM;       // 64: l of the s rows
  float* lt = ls + BW_T;                // 64: l of the t rows
  float* w = lt + BW_T;                 // 64: exp(l_{Q-1} - l_s)
  float* red = w + BW_T;                // 2 x 64: row sums of two warp columns

  const size_t x_ld = (size_t)H * P, b_ld = (size_t)G * N;
  const float* x_h = xw + (size_t)bc * Q * x_ld + (size_t)h * P;
  const float* dy_h = dy + (size_t)bc * Q * x_ld + (size_t)h * P;
  const float* b_g = Bm + (size_t)bc * Q * b_ld + (size_t)g * N;
  const float* c_g = Cm + (size_t)bc * Q * b_ld + (size_t)g * N;
  const float* l_h = l + (size_t)bc * Q * H + h;
  const float* dS_h = dS + ((size_t)bc * H + h) * N * P;
  const bool vec_x = (P & 3) == 0, vec_b = (N & 3) == 0;
  const int NW = n_nc * BW_T, PW = n_pc * BW_T;
  float gsum = 0.f;                     // tid < 64: row tid's running sum of G

  if ((int)blockIdx.y < n_tt * n_so) {
    // ---- an s block: rows s0.., p slice jo of dxw, n slice jo of dB ----
    const int is = (int)blockIdx.y / n_so, jo = (int)blockIdx.y % n_so;
    const int s0 = is * BW_T;
    const bool has_p = jo < n_pc, has_n = jo < n_nc, need_m = has_p || jo == 0;
    bw_stage(bs, ldn, b_g, b_ld, s0, Q, NW, N, vec_b);
    bw_stage(xs, ldp, x_h, x_ld, s0, Q, PW, P, vec_x);
    bw_stage_l(ls, l_h, H, s0, Q);
    float xacc[8][4] = {}, bacc[8][4] = {};
    for (int it = is; it < n_tt; ++it) {
      const int t0 = it * BW_T;
      bw_stage(cs, ldn, c_g, b_ld, t0, Q, NW, N, vec_b);
      bw_stage(ds, ldp, dy_h, x_ld, t0, Q, PW, P, vec_x);
      bw_stage_l(lt, l_h, H, t0, Q);
      __syncthreads();
      // rows s r0.., columns t c0..: dead when every s is past every t
      const bool live = !(it == is && r0 > c0 + 31);
      float acc[8][4] = {};
      if (need_m) {
        if (live) bw_mm_nt(bs, ldn, cs, ldn, N4, r0, c0, ly, lx, acc);  // (C B^T)^T
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int row = r0 + ly + 4 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = c0 + lx + 8 * j, t = t0 + col;
            float mv = 0.f;
            if (live && s0 + row <= t && t < Q) mv = acc[i][j] * expf(lt[col] - ls[row]);
            mt[row * BW_LDM + col] = mv;
            acc[i][j] = 0.f;
          }
        }
      }
      if (live) bw_mm_nt(xs, ldp, ds, ldp, P4, r0, c0, ly, lx, acc);    // (dy xw^T)^T
      float part[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = r0 + ly + 4 * i;
        part[i] = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = c0 + lx + 8 * j, t = t0 + col;
          float e = 0.f;
          if (live && s0 + row <= t && t < Q) e = expf(lt[col] - ls[row]);
          dt[row * BW_LDM + col] = acc[i][j] * e;
          if (jo == 0) part[i] += acc[i][j] * mt[row * BW_LDM + col];
        }
      }
      if (jo == 0) bw_row_sums(part, red, r0, c0, ly, lx);
      __syncthreads();                  // M^T, (dM E)^T and the row sums are whole
      if (jo == 0 && tid < BW_T) gsum += red[tid] + red[BW_T + tid];
      if (has_p) bw_mm_nn(mt, BW_LDM, ds + jo * BW_T, ldp, r0, c0, ly, lx, xacc);
      if (has_n) bw_mm_nn(dt, BW_LDM, cs + jo * BW_T, ldn, r0, c0, ly, lx, bacc);
      __syncthreads();                  // the t tile's buffers are free
    }
    // the state terms
    const float l_end = __ldg(l_h + (size_t)(Q - 1) * H);
    if (tid < BW_T) w[tid] = s0 + tid < Q ? expf(l_end - ls[tid]) : 0.f;
    float part[8] = {};
    if (has_p) {                        // Z = B_s dS[:, p slice]; dxw += w Z
      const int p0 = jo * BW_T;
      float acc[8][4] = {};
      for (int k0 = 0; k0 < NW; k0 += BW_T) {
        bw_stage(cs, ldn, dS_h + p0, P, k0, N, BW_T, P - p0, vec_x);
        __syncthreads();
        bw_mm_nn(bs + k0, ldn, cs, ldn, r0, c0, ly, lx, acc);
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = r0 + ly + 4 * i;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float z = w[row] * acc[i][q];
          xacc[i][q] += z;
          part[i] = fmaf(xs[row * ldp + p0 + c0 + 4 * lx + q], z, part[i]);  // u_s
        }
      }
      bw_row_sums(part, red, r0, c0, ly, lx);
    }
    if (has_n) {                        // V = xw_s dS[n slice, :]^T; dB += w V
      const int n0 = jo * BW_T;
      float acc[8][4] = {};
      for (int k0 = 0; k0 < PW; k0 += BW_T) {
        bw_stage_t(ds, ldp, dS_h, P, n0, N, k0, P);
        __syncthreads();
        bw_mm_nn(xs + k0, ldp, ds, ldp, r0, c0, ly, lx, acc);
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float wr = w[r0 + ly + 4 * i];
#pragma unroll
        for (int q = 0; q < 4; ++q) bacc[i][q] = fmaf(wr, acc[i][q], bacc[i][q]);
      }
    }
    __syncthreads();                    // u's row sums are whole
    if (tid < BW_T && s0 + tid < Q) {
      const size_t at = ((size_t)bc * Q + s0 + tid) * H + h;
      if (jo == 0) colG[at] = gsum;
      if (has_p) upart[(((size_t)bc * H + h) * n_pc + jo) * Q + s0 + tid] =
          red[tid] + red[BW_T + tid];
    }
    const int cc = jo * BW_T + c0 + 4 * lx;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int s = s0 + r0 + ly + 4 * i;
      if (s >= Q) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (has_p && cc + q < P) dxw[((size_t)bc * Q + s) * x_ld + (size_t)h * P + cc + q] = xacc[i][q];
        if (has_n && cc + q < N) dBh[(((size_t)bc * Q + s) * H + h) * N + cc + q] = bacc[i][q];
      }
    }
    return;
  }

  // ---- a t block: rows t0.., n slice jn of dC ----
  const int yy = (int)blockIdx.y - n_tt * n_so;
  const int it = n_tt - 1 - yy / n_nc, jn = yy % n_nc;  // heaviest tile first
  const int t0 = it * BW_T;
  bw_stage(cs, ldn, c_g, b_ld, t0, Q, NW, N, vec_b);
  bw_stage(ds, ldp, dy_h, x_ld, t0, Q, PW, P, vec_x);
  bw_stage_l(lt, l_h, H, t0, Q);
  float cacc[8][4] = {};
  for (int is = 0; is <= it; ++is) {
    const int s0 = is * BW_T;
    bw_stage(bs, ldn, b_g, b_ld, s0, Q, NW, N, vec_b);
    bw_stage(xs, ldp, x_h, x_ld, s0, Q, PW, P, vec_x);
    bw_stage_l(ls, l_h, H, s0, Q);
    __syncthreads();
    // rows t r0.., columns s c0..: dead when every s is past every t
    const bool live = !(is == it && c0 > r0 + 31);
    float acc[8][4] = {};
    if (jn == 0) {
      if (live) bw_mm_nt(cs, ldn, bs, ldn, N4, r0, c0, ly, lx, acc);    // C B^T
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = r0 + ly + 4 * i, t = t0 + row;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = c0 + lx + 8 * j;
          float mv = 0.f;
          if (live && s0 + col <= t && t < Q) mv = acc[i][j] * expf(lt[row] - ls[col]);
          mt[row * BW_LDM + col] = mv;
          acc[i][j] = 0.f;
        }
      }
    }
    if (live) bw_mm_nt(ds, ldp, xs, ldp, P4, r0, c0, ly, lx, acc);      // dy xw^T
    float part[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = r0 + ly + 4 * i, t = t0 + row;
      part[i] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + lx + 8 * j;
        float e = 0.f;
        if (live && s0 + col <= t && t < Q) e = expf(lt[row] - ls[col]);
        dt[row * BW_LDM + col] = acc[i][j] * e;
        if (jn == 0) part[i] += acc[i][j] * mt[row * BW_LDM + col];
      }
    }
    if (jn == 0) bw_row_sums(part, red, r0, c0, ly, lx);
    __syncthreads();
    if (jn == 0 && tid < BW_T) gsum += red[tid] + red[BW_T + tid];
    bw_mm_nn(dt, BW_LDM, bs + jn * BW_T, ldn, r0, c0, ly, lx, cacc);
    __syncthreads();
  }
  if (jn == 0 && tid < BW_T && t0 + tid < Q) rowG[((size_t)bc * Q + t0 + tid) * H + h] = gsum;
  const int cc = jn * BW_T + c0 + 4 * lx;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = t0 + r0 + ly + 4 * i;
    if (t >= Q) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (cc + q < N) dCh[(((size_t)bc * Q + t) * H + h) * N + cc + q] = cacc[i][q];
  }
}

// The fixed-order sums. Threads [0, BC*Q*G*N): dB and dC of one (bc, q, g, n)
// over the group's heads in ascending order. Threads past them: dl of one
// (bc, h) for every q, = rows - columns - u_q (u_q the sum of its p slices),
// and at q = Q - 1 + the sum of u over q in ascending order.
__global__ void ssd_bwd_reduce_kernel(const float* __restrict__ dBh,
                                      const float* __restrict__ dCh,
                                      const float* __restrict__ rowG,
                                      const float* __restrict__ colG,
                                      const float* __restrict__ upart,
                                      float* __restrict__ dB, float* __restrict__ dC,
                                      float* __restrict__ dl, int BC, int Q, int H,
                                      int G, int N, int n_pc) {
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
  const long long j = i - n_bcn;
  if (j >= (long long)BC * H) return;
  const int bc = (int)(j / H), h = (int)(j % H);
  const float* up = upart + ((size_t)bc * H + h) * n_pc * Q;
  float usum = 0.f;
  for (int q = 0; q < Q; ++q) {
    float u = 0.f;
    for (int k = 0; k < n_pc; ++k) u += up[(size_t)k * Q + q];
    const size_t at = ((size_t)bc * Q + q) * H + h;
    dl[at] = rowG[at] - colG[at] - u;
    usum += u;
  }
  dl[((size_t)bc * Q + Q - 1) * H + h] += usum;
}

// xw, dy (BC, Q, H, P); Bm, Cm (BC, Q, G, N); l (BC, Q, H); dS (BC, H, N, P)
// -> dxw (BC, Q, H, P), dB, dC (BC, Q, G, N), dl (BC, Q, H); all float32,
// contiguous, 16-byte aligned, on one device; BC = batch * chunks; G divides
// H. scratch holds BC*Q*H*(2N + 2 + ceil(P / 64)) floats
// (kernels/ssd.py::bwd_scratch_floats): the per-head dB and dC, the row and
// column sums of G, and u_s per p slice. Two launches on the current stream.
// Returns a cudaError_t (0 on success); a shape the grid or shared memory
// cannot hold is refused with cudaErrorInvalidValue.
extern "C" int l2s_ssd_intra_bwd(const float* xw, const float* Bm, const float* Cm,
                                 const float* l, const float* dy, const float* dS,
                                 float* dxw, float* dB, float* dC, float* dl,
                                 float* scratch, int BC, int Q, int H, int P, int G,
                                 int N, void* stream) {
  if (BC <= 0 || Q <= 0 || H <= 0) return (int)cudaSuccess;
  if (G <= 0 || H % G || P <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const int n_tt = (Q + BW_T - 1) / BW_T;
  const int n_pc = (P + BW_T - 1) / BW_T, n_nc = (N + BW_T - 1) / BW_T;
  const int n_so = n_pc > n_nc ? n_pc : n_nc;
  const long long blocks_x = (long long)BC * H;
  const long long blocks_y = (long long)n_tt * (n_so + n_nc);
  if (blocks_x > 0x7fffffffLL || blocks_y > 65535) return (int)cudaErrorInvalidValue;
  const size_t ldn = (size_t)n_nc * BW_T + 4, ldp = (size_t)n_pc * BW_T + 4;
  const size_t smem =
      (2 * BW_T * ldn + 2 * BW_T * ldp + 2 * BW_T * BW_LDM + 5 * BW_T) * sizeof(float);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = l2s_allow_smem(ssd_intra_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const size_t rows = (size_t)BC * Q * H;
  float* dBh = scratch;
  float* dCh = dBh + rows * N;
  float* rowG = dCh + rows * N;
  float* colG = rowG + rows;
  float* upart = colG + rows;
  cudaStream_t s = (cudaStream_t)stream;
  ssd_intra_bwd_kernel<<<dim3((unsigned)blocks_x, (unsigned)blocks_y), BW_THREADS, smem,
                         s>>>(xw, Bm, Cm, l, dy, dS, dxw, dBh, dCh, rowG, colG, upart,
                              Q, H, P, G, N, n_tt, n_so, n_pc, n_nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)BC * Q * G * N + (long long)BC * H;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ssd_bwd_reduce_kernel<<<(unsigned)blocks, threads, 0, s>>>(
      dBh, dCh, rowG, colG, upart, dB, dC, dl, BC, Q, H, G, N, n_pc);
  return (int)cudaGetLastError();
}
