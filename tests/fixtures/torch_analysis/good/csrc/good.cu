// Launches that keep sm_90's contracts (RA4xx): scanned, never built.
#include <cuda_runtime.h>

constexpr int kRows = 64;
constexpr size_t kSmem = 100 * 1024;

__global__ void small_static(float* out) {
  __shared__ float tile[kRows][kRows];  // 16 KB
  out[threadIdx.x] = tile[0][threadIdx.x];
}

__global__ void dyn(float* out) {
  extern __shared__ float smem[];
  out[threadIdx.x] = smem[threadIdx.x];
}

int launch_default(float* out, cudaStream_t stream) {
  dyn<<<1, 128, 32 * 1024, stream>>>(out);
  small_static<<<1, 64, 0, stream>>>(out);
  small_static<<<1, 64>>>(out);
  return 0;
}

int launch_opted(float* out, cudaStream_t stream) {
  cudaFuncSetAttribute(dyn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)kSmem);
  dyn<<<1, 128, kSmem, stream>>>(out);
  return 0;
}

static int allow(void (*k)(float*)) {
  return (int)cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
}

int launch_cluster(float* out, size_t smem, cudaStream_t stream) {
  allow(dyn);
  cudaFuncSetAttribute(dyn, cudaFuncAttributeNonPortableClusterSizeAllowed,
                       1);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(16);
  cfg.blockDim = dim3(128);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 16;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, dyn, out);
}

int launch_waived(float* out, size_t smem, cudaStream_t stream) {
  // repro-analysis: disable=RA405 reason=fixture: every caller opts in first
  dyn<<<1, 128, smem, stream>>>(out);
  return 0;
}

__global__ void __cluster_dims__(2, 4, 1) clustered(float* out) {
  out[0] = 0.f;
}
