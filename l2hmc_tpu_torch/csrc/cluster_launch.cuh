// Launching a kernel on thread-block clusters of G CTAs, and asking how
// many such clusters the card holds at once (the VAE cluster kernels:
// vae_cluster.cuh, vae_stream.cuh).
#pragma once
#include <cuda_runtime.h>

namespace l2hmc {

constexpr size_t kClusterMaxSmem = 232448;  // bytes one CTA may use on Hopper

// A launch of `clusters` clusters of G CTAs of `threads` threads with
// `smem` bytes of dynamic shared memory each; a refused launch returns its
// error.
template <class... Params, class... Args>
inline cudaError_t launch_clusters(void (*kernel)(Params...), int G,
                                   int clusters, int threads, size_t smem,
                                   cudaStream_t stream, Args... args) {
  if (smem > kClusterMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * G);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// How many clusters of G CTAs of `threads` threads with `smem` bytes each
// the card holds at once (a negative CUDA error code if the query fails).
template <class K>
inline int max_clusters(K kernel, int G, int threads, size_t smem) {
  if (smem > kClusterMaxSmem) return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

}  // namespace l2hmc
