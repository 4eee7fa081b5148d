// The card's rate for the mma.sync instruction the SSD backward kernel
// (src/repro_torch/csrc/ssd_bwd.cu) is built on, m16n8k8 TF32 with float32
// accumulators, beside m16n8k16 fp16 for scale: each warp issues rounds of
// NACC independent mmas on register operands, so nothing but the tensor
// cores limits it. Build and run on the card:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/mma_tf32_bench \
//        tools/mma_tf32_bench.cu && ./build/mma_tf32_bench
//
// Prints TFLOP/s (2 flops a multiply-add, CUDA events) for a few block
// shapes, with the card's name and power limit.
#include <cstdint>
#include <cstdio>
#include <cstdlib>

#include <cuda_runtime.h>

template <int NACC>
__global__ void mma_tf32(float* out, int iters) {
  float c[NACC][4] = {};
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + i);
  b[0] = __float_as_uint(0.5f);
  b[1] = __float_as_uint(0.25f);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < NACC; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
          "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
  for (int j = 0; j < NACC; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int NACC>
__global__ void mma_f16(float* out, int iters) {
  float c[NACC][4] = {};
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = 0x3c003c00u;  // (1.0, 1.0) in fp16
  b[0] = b[1] = 0x3c003c00u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < NACC; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, "
          "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
  for (int j = 0; j < NACC; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <typename Kernel>
static void run(const char* name, Kernel kernel, int warps, int blocks, int nacc,
                double flops_per_mma) {
  const int iters = 20000;
  float* out;
  cudaMalloc(&out, (size_t)blocks * warps * 32 * sizeof(float));
  kernel<<<blocks, warps * 32>>>(out, 10);  // warm-up
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  kernel<<<blocks, warps * 32>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  const double n = (double)blocks * warps * iters * nacc;
  std::printf("%s: %d warps a block, %d blocks, %d independent mmas a warp: %.3f ms, "
              "%.1f TFLOP/s\n", name, warps, blocks, nacc, ms,
              n * flops_per_mma / ms / 1e9);
  cudaFree(out);
}

int main() {
  std::fflush(stdout);
  if (std::system("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader") != 0)
    std::printf("nvidia-smi failed\n");
  run("m16n8k8 tf32", mma_tf32<4>, 4, 132, 4, 2048.0);
  run("m16n8k8 tf32", mma_tf32<4>, 8, 264, 4, 2048.0);
  run("m16n8k8 tf32", mma_tf32<8>, 16, 264, 8, 2048.0);
  run("m16n8k16 f16", mma_f16<8>, 8, 264, 8, 4096.0);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    std::printf("CUDA error: %s\n", cudaGetErrorString(err));
    return 1;
  }
  return 0;
}
