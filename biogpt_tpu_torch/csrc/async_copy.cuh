// Hopper's asynchronous copies, mbarriers, cluster barriers and
// programmatic dependent launch, shared by the attention kernels
// (attn_paged.cuh, attn_batched.cuh), the tensor-core GEMVs
// (qgemv_mma.cuh, qgemv_b1.cuh, qmatmul.cu) and the refill chain
// (prefill.cu).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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

// 16 bytes global -> shared, the bytes past `src_bytes` (0 or 16) zero
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

// arrive on mbarrier `bar` once this thread's cp.async copies so far have
// landed (the arrival counted in the barrier's expected count)
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(a)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// mbarrier in shared memory: `count` arrivals complete a phase
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n"
               ::"r"(smem_addr(bar)) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const unsigned a = smem_addr(bar);
  unsigned done = 0;
  while (!done)
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(a), "r"(parity) : "memory");
}

// the mbarrier's current phase also waits for `bytes` of asynchronous
// stores or copies (this thread's arrival counted)
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// make the mbarriers this thread initialized visible to the cluster's
// asynchronous stores
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// make this thread's shared-memory writes (plain stores, cp.async) visible
// to the async proxy (wgmma's operand reads)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier `id` (1..15) over `threads` threads of the block
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The cluster barrier in two halves: every thread of every block of the
// cluster arrives, then waits for all (acquire: the other blocks' shared
// memory writes before their arrival are visible). `relaxed` arrives
// order no memory.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The shared::cluster address of `p` (this CTA's shared memory) in the
// CTA of rank `rank` of the cluster.
__device__ __forceinline__ unsigned cluster_addr(const void* p, int rank) {
  unsigned a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a) : "r"(smem_addr(p)), "r"(rank));
  return a;
}

// Store to a cluster CTA's shared memory (address from cluster_addr) and
// count its bytes on the mbarrier at `bar` (cluster_addr) of that CTA.
__device__ __forceinline__ void st_async(unsigned addr, float v,
                                         unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];\n" ::"r"(addr), "f"(v), "r"(bar) : "memory");
}

// wait for phase `parity` of an mbarrier that other CTAs of the cluster
// complete (acquire at cluster scope: their stores are visible)
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, int parity) {
  const unsigned a = smem_addr(bar);
  unsigned done = 0;
  while (!done)
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, "
                 "[%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(a), "r"(parity) : "memory");
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
// `cluster` the cluster's shape (1 x 1 x 1: no cluster), `smem` the
// dynamic shared memory bytes.
template <typename... Params, typename... Args>
inline void launch_dependent_ex(void (*kernel)(Params...), dim3 grid,
                                dim3 block, dim3 cluster, size_t smem,
                                cudaStream_t st, Args... args) {
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = cluster.x;
  attr[1].val.clusterDim.y = cluster.y;
  attr[1].val.clusterDim.z = cluster.z;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = cluster.x * cluster.y * cluster.z > 1 ? 2 : 1;
  cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <typename... Params, typename... Args>
inline void launch_dependent(void (*kernel)(Params...), dim3 grid, dim3 block,
                             int cluster_y, cudaStream_t st, Args... args) {
  launch_dependent_ex(kernel, grid, block, dim3(1, cluster_y, 1), 0, st,
                      args...);
}

}  // namespace bgt
