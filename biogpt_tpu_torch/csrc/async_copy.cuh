// Hopper's asynchronous copies and programmatic dependent launch, shared by
// the paged attention (attn_paged.cuh) and the tensor-core GEMV
// (qgemv_mma.cuh).
#pragma once

#include <cuda_runtime.h>

namespace bgt {

// 16 bytes global -> shared, around L1 (cp.async.cg)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// 4 bytes global -> shared (cp.async.ca)
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Programmatic dependent launch: a kernel launched with
// launch_dependent() may start while the kernel before it in the stream
// runs; it issues what does not depend on that kernel (the weights), then
// pdl_wait() holds every thread until the kernel before has finished and
// its writes are visible. pdl_trigger() lets the next such kernel start.
__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void pdl_trigger() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
}

// Launch `kernel` so that it may start while the stream's previous kernel
// runs (programmatic dependent launch): it must pdl_wait() before it reads
// that kernel's outputs or writes anything. cluster_y > 1: blocks (x, y)
// with the same x and y / cluster_y form one thread block cluster.
template <typename... Params, typename... Args>
inline void launch_dependent(void (*kernel)(Params...), dim3 grid, dim3 block,
                             int cluster_y, cudaStream_t st, Args... args) {
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = 1;
  attr[1].val.clusterDim.y = cluster_y;
  attr[1].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = cluster_y > 1 ? 2 : 1;
  cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace bgt
