// Known-bad launch contracts (RA4xx): lines marked `// expect: CODE` are
// asserted exactly by tests/test_torch_analysis.py; scanned, never built.
#include <cuda_runtime.h>

constexpr int kTile = 256;
constexpr size_t kHugeSmem = 240 * 1024;  // expect: RA404

__global__ void big_static(float* out) {  // expect: RA404
  __shared__ float tile[kTile][kTile];
  out[threadIdx.x] = tile[0][threadIdx.x];
}

__global__ void dyn(float* out) {
  extern __shared__ float smem[];
  out[threadIdx.x] = smem[threadIdx.x];
}

int launch_literal(float* out, cudaStream_t stream) {
  dyn<<<1, 128, 64 * 1024, stream>>>(out);  // expect: RA405
  return 0;
}

int launch_runtime(float* out, size_t smem, cudaStream_t stream) {
  dyn<<<1, 128, smem, stream>>>(out);  // expect: RA405
  return 0;
}

int launch_too_much(float* out, cudaStream_t stream) {
  cudaFuncSetAttribute(dyn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)kHugeSmem);
  dyn<<<1, 128, kHugeSmem, stream>>>(out);  // expect: RA404
  return 0;
}

int launch_ex(float* out, size_t smem, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(16);
  cfg.blockDim = dim3(128);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 16;  // expect: RA406
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, dyn, out);  // expect: RA405
}

__global__ void __cluster_dims__(4, 4, 1) clustered(float* out) {  // expect: RA406
  out[0] = 0.f;
}
