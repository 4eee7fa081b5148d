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
// products plus the chunk state is ~6.7e9 float32 flops against ~1e8 bytes
// of inputs and outputs. The work must stay in IEEE float32 (the reference
// holds it to 1e-4): no TF32 mma, no fast-math exp, so the products run on
// the FMA units from shared memory.
//
// Design. A block's shared memory (227 KB) cannot hold a whole chunk at
// mamba2-1.3b's N = 128 (B and C alone take 256 KB at Q = 256), so the block
// tiles t and streams s. Grid: x = (batch*chunk, tile), y = head, where tile
// runs over ceil(Q / 64) blocks of 64 rows t plus one more block that computes
// the chunk state S. A row block
//   A. stages its 64 rows of C (zero past Q) and, for each 64-row tile of s
//      up to its last row t, a tile of B; a 16 x 16 thread grid, each thread a
//      4 x 4 micro-tile, forms C_t . B_s with fmaf in ascending n, then writes
//      M[t][s] = (C_t . B_s) * exp(l_t - l_s) for s <= t and 0 above the
//      diagonal (the mask comes before the exp: a dead position is never the
//      exp of a positive difference) into a 64 x (s extent) tile in shared
//      memory;
//   B. for each 64-column slice of P, streams xw's s tiles and accumulates
//      y[t][p] = sum_s M[t][s] xw[s][p] in registers, s ascending, and writes y.
// The state block streams 64-row tiles of s: Bw = B * exp(l_{Q-1} - l_s)
// (the reference's order: scale B, then the product) and xw, and accumulates
// S[n][p] in 4 x 4 micro-tiles over 64 x 64 slices of (N, P).
// Rows are padded to N + 1 floats where a warp reads 16 rows at one column,
// so those reads fall in distinct banks.
#include "l2s_common.cuh"

#define SSD_TILE 64      // rows t of a block; rows s of a streamed tile
#define SSD_THREADS 256  // 16 x 16 threads, each a 4 x 4 micro-tile of 64 x 64

// dst[r * dst_ld + c] = src[(r0 + r) * src_ld + c0 + c] for r < 64, c < ncols;
// 0 where r0 + r >= rmax or c0 + c >= cmax. A scale per source row, if given.
__device__ __forceinline__ void ssd_stage(const float* __restrict__ src,
                                          size_t src_ld, int r0, int rmax,
                                          int c0, int cmax, int ncols,
                                          float* __restrict__ dst, int dst_ld,
                                          const float* __restrict__ row_scale) {
  for (int i = threadIdx.x; i < SSD_TILE * ncols; i += blockDim.x) {
    const int r = i / ncols, c = i - r * ncols;
    const int gr = r0 + r, gc = c0 + c;
    float v = 0.f;
    if (gr < rmax && gc < cmax) {
      v = __ldg(src + (size_t)gr * src_ld + gc);
      if (row_scale) v *= row_scale[gr];
    }
    dst[r * dst_ld + c] = v;
  }
}

__global__ void __launch_bounds__(SSD_THREADS)
ssd_intra_kernel(const float* __restrict__ xw, const float* __restrict__ Bm,
                 const float* __restrict__ Cm, const float* __restrict__ l,
                 float* __restrict__ y, float* __restrict__ S, int Q, int H,
                 int P, int G, int N, int n_ttiles) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int tile = blockIdx.x % (n_ttiles + 1);
  const int bc = blockIdx.x / (n_ttiles + 1);
  const int h = blockIdx.y;
  const int g = h / (H / G);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  // row t of head h / group g starts at base + t * stride
  const size_t x_ld = (size_t)H * P, b_ld = (size_t)G * N;
  const float* x_h = xw + (size_t)bc * Q * x_ld + (size_t)h * P;
  const float* b_g = Bm + (size_t)bc * Q * b_ld + (size_t)g * N;
  const float* c_g = Cm + (size_t)bc * Q * b_ld + (size_t)g * N;
  const float* l_h = l + (size_t)bc * Q * H + h;

  if (tile == n_ttiles) {
    // ---- the chunk state S (N x P) ----
    float* w = sm;                                  // n_ttiles * 64
    float* bw = w + n_ttiles * SSD_TILE;            // 64 x 64
    float* xs = bw + SSD_TILE * SSD_TILE;           // 64 x 64
    const float l_end = __ldg(l_h + (size_t)(Q - 1) * H);
    for (int s = threadIdx.x; s < Q; s += blockDim.x)
      w[s] = expf(l_end - __ldg(l_h + (size_t)s * H));
    __syncthreads();
    float* S_h = S + ((size_t)bc * H + h) * N * P;
    for (int n0 = 0; n0 < N; n0 += SSD_TILE) {
      for (int p0 = 0; p0 < P; p0 += SSD_TILE) {
        float acc[4][4] = {};
        for (int s0 = 0; s0 < Q; s0 += SSD_TILE) {
          ssd_stage(b_g, b_ld, s0, Q, n0, N, SSD_TILE, bw, SSD_TILE, w);
          ssd_stage(x_h, x_ld, s0, Q, p0, P, SSD_TILE, xs, SSD_TILE, nullptr);
          __syncthreads();
          const int s_hi = min(SSD_TILE, Q - s0);
          for (int s = 0; s < s_hi; ++s) {
            float a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = bw[s * SSD_TILE + ty + 16 * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = xs[s * SSD_TILE + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
          }
          __syncthreads();
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int n = n0 + ty + 16 * i;
          if (n >= N) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int p = p0 + tx + 16 * j;
            if (p < P) S_h[(size_t)n * P + p] = acc[i][j];
          }
        }
      }
    }
    return;
  }

  // ---- 64 rows t of y ----
  const int t0 = tile * SSD_TILE;
  const int t_end = min(t0 + SSD_TILE, Q);          // rows t0 .. t_end - 1
  const int n_stiles = tile + 1;                    // s tiles covering s < t_end
  const int ldm = n_stiles * SSD_TILE + 1;
  const int ldn = N + 1;
  float* m = sm;                                    // 64 x ldm
  float* cs = m + SSD_TILE * ldm;                   // 64 x ldn
  float* lt = cs + SSD_TILE * ldn;                  // 64
  float* ls = lt + SSD_TILE;                        // n_stiles * 64
  float* stage = ls + n_stiles * SSD_TILE;          // max(64 x ldn, 64 x 64)

  ssd_stage(c_g, b_ld, t0, Q, 0, N, N, cs, ldn, nullptr);
  for (int s = threadIdx.x; s < t_end; s += blockDim.x) ls[s] = __ldg(l_h + (size_t)s * H);
  for (int r = threadIdx.x; r < SSD_TILE; r += blockDim.x)
    lt[r] = t0 + r < Q ? __ldg(l_h + (size_t)(t0 + r) * H) : 0.f;

  // A. M[t][s] = (C_t . B_s) exp(l_t - l_s) for s <= t, else 0
  for (int st = 0; st < n_stiles; ++st) {
    const int s0 = st * SSD_TILE;
    ssd_stage(b_g, b_ld, s0, Q, 0, N, N, stage, ldn, nullptr);
    __syncthreads();
    float acc[4][4] = {};
    for (int n = 0; n < N; ++n) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = cs[(ty + 16 * i) * ldn + n];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = stage[(tx + 16 * j) * ldn + n];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, t = t0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = s0 + tx + 16 * j;
        m[r * ldm + s] = (t < Q && s <= t) ? acc[i][j] * expf(lt[r] - ls[s]) : 0.f;
      }
    }
    __syncthreads();                                // before stage is reused
  }

  // B. y[t][p] = sum_{s < t_end} M[t][s] xw[s][p], 64 columns of P at a time
  float* y_h = y + (size_t)bc * Q * x_ld + (size_t)h * P;
  for (int p0 = 0; p0 < P; p0 += SSD_TILE) {
    float acc[4][4] = {};
    for (int st = 0; st < n_stiles; ++st) {
      const int s0 = st * SSD_TILE;
      ssd_stage(x_h, x_ld, s0, Q, p0, P, SSD_TILE, stage, SSD_TILE, nullptr);
      __syncthreads();
      const int s_hi = min(SSD_TILE, t_end - s0);
      for (int s = 0; s < s_hi; ++s) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = m[(ty + 16 * i) * ldm + s0 + s];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = stage[s * SSD_TILE + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + ty + 16 * i;
      if (t >= Q) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = p0 + tx + 16 * j;
        if (p < P) y_h[(size_t)t * x_ld + p] = acc[i][j];
      }
    }
  }
}

// Shared memory, in floats, of the largest block: the last row tile (its s
// extent is the whole chunk) or the state block.
static size_t ssd_smem_floats(int n_ttiles, int N) {
  const size_t ldn = (size_t)N + 1;
  const size_t stage = ldn * SSD_TILE > SSD_TILE * SSD_TILE ? ldn * SSD_TILE
                                                            : SSD_TILE * SSD_TILE;
  const size_t rows = (size_t)SSD_TILE * (n_ttiles * SSD_TILE + 1) + SSD_TILE * ldn +
                      SSD_TILE + (size_t)n_ttiles * SSD_TILE + stage;
  const size_t state = (size_t)n_ttiles * SSD_TILE + 2 * SSD_TILE * SSD_TILE;
  return rows > state ? rows : state;
}

// xw (BC, Q, H, P), Bm / Cm (BC, Q, G, N), l (BC, Q, H) -> y (BC, Q, H, P),
// S (BC, H, N, P); all float32, contiguous, on one device; BC = batch * chunks;
// G divides H. Returns a cudaError_t (0 on success); a chunk whose tiles need
// more shared memory than a block has is refused with cudaErrorInvalidValue.
extern "C" int l2s_ssd_intra(const float* xw, const float* Bm, const float* Cm,
                             const float* l, float* y, float* S, int BC, int Q,
                             int H, int P, int G, int N, void* stream) {
  if (BC <= 0 || Q <= 0 || H <= 0) return (int)cudaSuccess;
  if (G <= 0 || H % G || P <= 0 || N <= 0 || H > 65535) return (int)cudaErrorInvalidValue;
  const int n_ttiles = (Q + SSD_TILE - 1) / SSD_TILE;
  const size_t smem = ssd_smem_floats(n_ttiles, N) * sizeof(float);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = l2s_allow_smem(ssd_intra_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)BC * (n_ttiles + 1), H);
  ssd_intra_kernel<<<grid, SSD_THREADS, smem, (cudaStream_t)stream>>>(
      xw, Bm, Cm, l, y, S, Q, H, P, G, N, n_ttiles);
  return (int)cudaGetLastError();
}
