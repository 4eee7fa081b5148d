// ssd_intra: the Mamba2 SSD intra-chunk dual form, for every (batch, chunk, head):
//
//   y[t] = sum_{s <= t} exp(l_t - l_s) (C_t . B_s) xw_s          (Q x P)
//   S    = sum_s exp(l_{Q-1} - l_s) B_s (x) xw_s                  (N x P)
//
// with head h reading B/C group h / (H / G).
//
// Replaces the Pallas kernel src/repro/kernels/ssd.py::ssd_intra_pallas
// (_ssd_intra_kernel, pl.pallas_call at ssd.py:70), which holds one whole
// (batch, chunk, head) in VMEM — the (Q, Q) score tile and the (Q, N) / (Q, P)
// operands, ~0.6 MB at Q = 256, N = 128 — and runs two MXU products.
//
// Bound on the H100: operations. At zamba2-2.7b's prefill (B = 4, T = 512:
// nc = 2, Q = 256, H = 80, P = N = 64) the causal half of the two Q x Q
// products plus the chunk state is 6.7e9 float32 flops against 1e8 bytes of
// inputs and outputs. The work stays in IEEE float32 (the reference holds it
// to 1e-4): no TF32 mma, no fast-math exp, so the products run on the FMA
// units, fed from shared memory.
//
// Design. 128 threads (4 warps) per block; each warp owns a 32 x 32 quarter
// of a 64 x 64 tile and each thread an 8 x 4 register micro-tile, read with
// 128-bit shared loads: 12 loads feed 128 FMAs. Grid: x = batch*chunk x
// head; y = work items, heaviest first: the 64-row t tiles of y from the last
// (which sees the whole chunk) down, then the 64 x 64 tiles of the chunk
// state. For P > 64 each 64-column slice of P is its own item.
//   * A row block keeps its 64 rows of C in shared memory and, flash-style,
//     for each s tile up to its own: CB = C_t . B_s^T in registers (k = n in
//     float4 steps, both operands n-contiguous), M = CB * exp(l_t - l_s) with
//     the causal mask applied first (a dead position is 0, its exp never
//     evaluated), M to shared memory, then y += M . xw_s (k = s in float4
//     steps of M's rows, xw rows read as p-float4s). Shared memory does not
//     grow with Q: C, one B tile, one xw tile, one M tile (70 KB at N = 64,
//     103 KB at N = 128: three and two blocks per SM).
//   * The dead triangle is skipped per warp: inside the diagonal tile a warp
//     whose 32 x 32 quarter lies wholly above the diagonal does no products
//     (it writes M = 0), and the y product of each warp stops at the last s
//     its rows can see.
//   * cp.async (16-byte .cg copies, 4-byte where a width is ragged; zero-fill
//     past Q, N and P) keeps two copies in flight as a two-slot ring: the next
//     B tile lands under the current M . xw product, the next xw tile under
//     the next C . B product.
//   * A state block streams 64-row s tiles of B (its 64 columns of N) and xw
//     (its 64 columns of P) through two double-buffered slots, scales the B
//     tile by exp(l_{Q-1} - l_s) in place (the reference's order: scale B,
//     then the product) and accumulates S in 8 x 4 micro-tiles over s.
// Row strides: C and B tiles N + 4 (rounded to 4), M 72 floats, so each
// 128-bit load of a warp is a broadcast or conflict-free and M's scalar
// stores fall in 32 distinct banks.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W; CUDA-event
// medians, cold L2): 0.281 ms at zamba2's chunk (bound 0.1005 ms, 24 TFLOP/s
// of the bound's flops) and 0.387 ms at mamba2's (bound 0.1286 ms). 168
// registers, no spills.
// A 128-bit shared load costs a warp four shared-memory cycles, so an 8 x 4
// tile asks 1.5 shared cycles per FMA cycle of the SM: the shared pipe, and
// the 12 (N = 64) or 8 (N = 128) warps per SM that hide its latency, bound
// it. An 8 x 8 tile lowers that ratio to 1.0 but needs ~250 registers and
// leaves 8 warps per SM; it was slower in a trial at both shapes.
#include "l2s_common.cuh"

#define SSD_T 64         // rows t of a row block; rows s of a streamed tile; n / p width
#define SSD_THREADS 128  // 4 warps: a 32 x 32 quarter each, 8 x 4 per thread
#define SSD_LDM 72       // row stride of the M tile
#define SSD_MINB 3       // blocks per SM the register budget is cut for

__device__ __forceinline__ void ssd_cp16(float* dst, const float* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void ssd_cp4(float* dst, const float* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void ssd_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void ssd_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

// Queue copies of a 64-row tile: dst[r * dld + c] = src[(r0 + r) * sld + c]
// for r < 64, c < cols; zero where r0 + r >= rmax or c >= cmax. 16-byte copies
// when vec (cols, cmax, sld and src all multiples of 4 floats), else 4-byte.
__device__ __forceinline__ void ssd_stage(float* dst, int dld, const float* src,
                                          size_t sld, int r0, int rmax, int cols,
                                          int cmax, bool vec) {
  if (vec) {
    const int c4 = cols >> 2;
    for (int i = threadIdx.x; i < SSD_T * c4; i += SSD_THREADS) {
      const int r = i / c4, c = (i - r * c4) << 2;
      const bool ok = r0 + r < rmax && c < cmax;
      ssd_cp16(dst + r * dld + c, ok ? src + (size_t)(r0 + r) * sld + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < SSD_T * cols; i += SSD_THREADS) {
      const int r = i / cols, c = i - r * cols;
      const bool ok = r0 + r < rmax && c < cmax;
      ssd_cp4(dst + r * dld + c, ok ? src + (size_t)(r0 + r) * sld + c : src, ok);
    }
  }
}

// Queue copies of l for rows r0 .. r0 + 63 of one head (stride H), 0 past Q.
__device__ __forceinline__ void ssd_stage_l(float* dst, const float* l_h, int H,
                                            int r0, int Q) {
  for (int r = threadIdx.x; r < SSD_T; r += SSD_THREADS) {
    const bool ok = r0 + r < Q;
    ssd_cp4(dst + r, ok ? l_h + (size_t)(r0 + r) * H : l_h, ok);
  }
}

__device__ __forceinline__ float4 ssd_ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[i][0..3] += a_i * (b.x, b.y, b.z, b.w)
#define SSD_FMA4(acc, a, b)          \
  acc[0] = fmaf(a, (b).x, acc[0]);   \
  acc[1] = fmaf(a, (b).y, acc[1]);   \
  acc[2] = fmaf(a, (b).z, acc[2]);   \
  acc[3] = fmaf(a, (b).w, acc[3]);

__global__ void __launch_bounds__(SSD_THREADS, SSD_MINB)
ssd_intra_kernel(const float* __restrict__ xw, const float* __restrict__ Bm,
                 const float* __restrict__ Cm, const float* __restrict__ l,
                 float* __restrict__ y, float* __restrict__ S, int Q, int H,
                 int P, int G, int N, int n_tt, int n_pc) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int bc = blockIdx.x / H, h = blockIdx.x - bc * H;
  const int g = h / (H / G);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ly = lane >> 3, lx = lane & 7;
  const int r0 = (warp >> 1) * 32, c0 = (warp & 1) * 32;  // the warp's quarter

  // row t of head h / group g starts at base + t * stride
  const size_t x_ld = (size_t)H * P, b_ld = (size_t)G * N;
  const float* x_h = xw + (size_t)bc * Q * x_ld + (size_t)h * P;
  const float* b_g = Bm + (size_t)bc * Q * b_ld + (size_t)g * N;
  const float* c_g = Cm + (size_t)bc * Q * b_ld + (size_t)g * N;
  const float* l_h = l + (size_t)bc * Q * H + h;
  const bool vec_x = (P & 3) == 0, vec_b = (N & 3) == 0;
  const int n_rows = n_tt * n_pc;

  if ((int)blockIdx.y >= n_rows) {
    // ---- a 64 x 64 tile (n0.., p0..) of the chunk state S ----
    const int item = blockIdx.y - n_rows;
    const int n0 = (item / n_pc) * SSD_T, p0 = (item % n_pc) * SSD_T;
    const int nw = min(SSD_T, N - n0), pw = min(SSD_T, P - p0);
    float* bs = sm;                            // 2 slots of 64 x 64
    float* xs = bs + 2 * SSD_T * SSD_T;        // 2 slots of 64 x 64
    float* ls = xs + 2 * SSD_T * SSD_T;        // 2 slots of 64
    float* w = ls + 2 * SSD_T;                 // 64
    const float l_end = __ldg(l_h + (size_t)(Q - 1) * H);
    const int n_st = (Q + SSD_T - 1) / SSD_T;
    ssd_stage(bs, SSD_T, b_g + n0, b_ld, 0, Q, SSD_T, nw, vec_b);
    ssd_stage(xs, SSD_T, x_h + p0, x_ld, 0, Q, SSD_T, pw, vec_x);
    ssd_stage_l(ls, l_h, H, 0, Q);
    ssd_commit();
    float acc[8][4] = {};
    const bool live = r0 < nw && c0 < pw;
    for (int st = 0; st < n_st; ++st) {
      const int slot = st & 1, s0 = st * SSD_T;
      float* b_t = bs + slot * SSD_T * SSD_T;
      float* x_t = xs + slot * SSD_T * SSD_T;
      if (st + 1 < n_st) {
        const int nxt = slot ^ 1;
        ssd_stage(bs + nxt * SSD_T * SSD_T, SSD_T, b_g + n0, b_ld, s0 + SSD_T, Q, SSD_T,
                  nw, vec_b);
        ssd_stage(xs + nxt * SSD_T * SSD_T, SSD_T, x_h + p0, x_ld, s0 + SSD_T, Q, SSD_T,
                  pw, vec_x);
        ssd_stage_l(ls + nxt * SSD_T, l_h, H, s0 + SSD_T, Q);
      }
      ssd_commit();
      ssd_wait1();                              // tile st has landed
      __syncthreads();
      if (threadIdx.x < SSD_T) w[threadIdx.x] = expf(l_end - ls[slot * SSD_T + threadIdx.x]);
      __syncthreads();
      for (int e = threadIdx.x; e < SSD_T * SSD_T; e += SSD_THREADS) b_t[e] *= w[e / SSD_T];
      __syncthreads();
      if (live) {
        const int s_hi = min(SSD_T, Q - s0);
        for (int s = 0; s < s_hi; ++s) {
          const float4 a0 = ssd_ld4(b_t + s * SSD_T + r0 + 8 * ly);
          const float4 a1 = ssd_ld4(b_t + s * SSD_T + r0 + 8 * ly + 4);
          const float4 xv = ssd_ld4(x_t + s * SSD_T + c0 + 4 * lx);
          SSD_FMA4(acc[0], a0.x, xv) SSD_FMA4(acc[1], a0.y, xv)
          SSD_FMA4(acc[2], a0.z, xv) SSD_FMA4(acc[3], a0.w, xv)
          SSD_FMA4(acc[4], a1.x, xv) SSD_FMA4(acc[5], a1.y, xv)
          SSD_FMA4(acc[6], a1.z, xv) SSD_FMA4(acc[7], a1.w, xv)
        }
      }
      __syncthreads();                          // slot free before its refill
    }
    if (!live) return;
    float* S_h = S + ((size_t)bc * H + h) * N * P;
    const int p = p0 + c0 + 4 * lx;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int n = n0 + r0 + 8 * ly + i;
      if (n >= N) continue;
      float* dst = S_h + (size_t)n * P + p;
      if (vec_x && p + 3 < P) {
        *reinterpret_cast<float4*>(dst) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (p + j < P) dst[j] = acc[i][j];
      }
    }
    return;
  }

  // ---- 64 rows t (t0..) x 64 columns p (p0..) of y ----
  const int it = n_tt - 1 - (int)blockIdx.y / n_pc;  // heaviest tile first
  const int t0 = it * SSD_T, p0 = ((int)blockIdx.y % n_pc) * SSD_T;
  const int pw = min(SSD_T, P - p0);
  const int N4 = (N + 3) & ~3, ldc = N4 + 4;
  float* cs = sm;                      // 64 x ldc: C rows t0..
  float* bs = cs + SSD_T * ldc;        // 64 x ldc: B rows of the current s tile
  float* xs = bs + SSD_T * ldc;        // 64 x 64: xw rows of the current s tile
  float* ms = xs + SSD_T * SSD_T;      // 64 x SSD_LDM: M of the current s tile
  float* lt = ms + SSD_T * SSD_LDM;    // 64
  float* ls = lt + SSD_T;              // 64

  ssd_stage(cs, ldc, c_g, b_ld, t0, Q, N4, N, vec_b);
  ssd_stage_l(lt, l_h, H, t0, Q);
  ssd_stage(bs, ldc, b_g, b_ld, 0, Q, N4, N, vec_b);
  ssd_stage_l(ls, l_h, H, 0, Q);
  ssd_commit();
  ssd_stage(xs, SSD_T, x_h + p0, x_ld, 0, Q, SSD_T, pw, vec_x);
  ssd_commit();

  float yacc[8][4] = {};
  const bool rows_live = t0 + r0 < Q;
  for (int st = 0; st <= it; ++st) {
    const int s0 = st * SSD_T;
    ssd_wait1();                                // C, B_st (and l) have landed
    __syncthreads();
    // CB = C_t . B_s^T over this warp's quarter (rows r0.., columns c0..),
    // thread rows r0 + ly + 4i, columns c0 + lx + 8j
    const bool live = rows_live && s0 + c0 < Q && s0 + c0 <= t0 + r0 + 31;
    float acc[8][4] = {};
    if (live) {
      const float* a_row = cs + (r0 + ly) * ldc;
      const float* b_row = bs + (c0 + lx) * ldc;
      for (int n = 0; n < N4; n += 4) {
        float4 a[8], b[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = ssd_ld4(a_row + 4 * i * ldc + n);
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = ssd_ld4(b_row + 8 * j * ldc + n);
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
    // M = CB * exp(l_t - l_s) for s <= t < Q, else 0 (mask before the exp)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = r0 + ly + 4 * i, t = t0 + row;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + lx + 8 * j, s = s0 + col;
        float mv = 0.f;
        if (live && s <= t && t < Q) mv = acc[i][j] * expf(lt[row] - ls[col]);
        ms[row * SSD_LDM + col] = mv;
      }
    }
    __syncthreads();                            // M complete; the B slot is free
    if (st < it) {
      ssd_stage(bs, ldc, b_g, b_ld, s0 + SSD_T, Q, N4, N, vec_b);
      ssd_stage_l(ls, l_h, H, s0 + SSD_T, Q);
    }
    ssd_commit();
    ssd_wait1();                                // xw_st has landed
    __syncthreads();
    // y += M . xw_s over this warp's quarter (rows r0.., p columns c0..),
    // thread rows r0 + ly + 4i, columns c0 + 4lx .. + 3; s stops at the
    // last one these rows can see
    const int kmax = min(SSD_T, min(t0 + r0 + 32 - s0, Q - s0));
    if (rows_live && c0 < pw && kmax > 0) {
      const int k4 = (kmax + 3) & ~3;
      const float* m_row = ms + (r0 + ly) * SSD_LDM;
      const float* x_col = xs + c0 + 4 * lx;
      for (int k = 0; k < k4; k += 4) {
        float4 m[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) m[i] = ssd_ld4(m_row + 4 * i * SSD_LDM + k);
        const float4 x0 = ssd_ld4(x_col + k * SSD_T);
        const float4 x1 = ssd_ld4(x_col + (k + 1) * SSD_T);
        const float4 x2 = ssd_ld4(x_col + (k + 2) * SSD_T);
        const float4 x3 = ssd_ld4(x_col + (k + 3) * SSD_T);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          SSD_FMA4(yacc[i], m[i].x, x0)
          SSD_FMA4(yacc[i], m[i].y, x1)
          SSD_FMA4(yacc[i], m[i].z, x2)
          SSD_FMA4(yacc[i], m[i].w, x3)
        }
      }
    }
    __syncthreads();                            // M and the xw slot are free
    if (st < it) ssd_stage(xs, SSD_T, x_h + p0, x_ld, s0 + SSD_T, Q, SSD_T, pw, vec_x);
    ssd_commit();
  }

  if (!rows_live || c0 >= pw) return;
  float* y_h = y + (size_t)bc * Q * x_ld + (size_t)h * P;
  const int p = p0 + c0 + 4 * lx;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = t0 + r0 + ly + 4 * i;
    if (t >= Q) continue;
    float* dst = y_h + (size_t)t * x_ld + p;
    if (vec_x && p + 3 < P) {
      *reinterpret_cast<float4*>(dst) =
          make_float4(yacc[i][0], yacc[i][1], yacc[i][2], yacc[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (p + j < P) dst[j] = yacc[i][j];
    }
  }
}

// Shared memory, in floats, of the larger kind of block.
static size_t ssd_smem_floats(int N) {
  const size_t ldc = (size_t)((N + 3) & ~3) + 4;
  const size_t rows = 2 * SSD_T * ldc + SSD_T * SSD_T + SSD_T * SSD_LDM + 2 * SSD_T;
  const size_t state = 4 * SSD_T * SSD_T + 3 * SSD_T;
  return rows > state ? rows : state;
}

// xw (BC, Q, H, P), Bm / Cm (BC, Q, G, N), l (BC, Q, H) -> y (BC, Q, H, P),
// S (BC, H, N, P); all float32, contiguous, 16-byte aligned, on one device;
// BC = batch * chunks; G divides H. Any Q; N up to about 380 (a row block's C
// and B tiles must fit its shared memory). Returns a cudaError_t (0 on
// success); a shape the grid or shared memory cannot hold is refused with
// cudaErrorInvalidValue.
extern "C" int l2s_ssd_intra(const float* xw, const float* Bm, const float* Cm,
                             const float* l, float* y, float* S, int BC, int Q,
                             int H, int P, int G, int N, void* stream) {
  if (BC <= 0 || Q <= 0 || H <= 0) return (int)cudaSuccess;
  if (G <= 0 || H % G || P <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const int n_tt = (Q + SSD_T - 1) / SSD_T;
  const int n_pc = (P + SSD_T - 1) / SSD_T, n_nc = (N + SSD_T - 1) / SSD_T;
  const long long blocks_x = (long long)BC * H, blocks_y = (long long)n_pc * (n_tt + n_nc);
  if (blocks_x > 0x7fffffffLL || blocks_y > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = ssd_smem_floats(N) * sizeof(float);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = l2s_allow_smem(ssd_intra_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)blocks_x, (unsigned)blocks_y);
  ssd_intra_kernel<<<grid, SSD_THREADS, smem, (cudaStream_t)stream>>>(
      xw, Bm, Cm, l, y, S, Q, H, P, G, N, n_tt, n_pc);
  return (int)cudaGetLastError();
}
