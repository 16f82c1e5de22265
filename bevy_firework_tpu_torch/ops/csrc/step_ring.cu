// The step kernel's instantiations for solo launches with the ring claim
// (fused_step_kernel.cuh; hybrid frames' in step_merge.cu); bf_fused_step in fused_step.cu selects and launches
// them.

#include "fused_step_kernel.cuh"

extern "C" const void* bf_step_kernel_ring(int collide, int fields, int stats) {
  return select_step_kernel<true, false>(collide != 0, fields != 0, stats != 0);
}

// The solo main path (stats 0) or its stats twin with the cadence on warp
// 0's lanes (fused_step_kernel_warp: U > 1, up to 32 emitters).
extern "C" const void* bf_step_kernel_ring_warp(int stats) {
  return stats ? (const void*)fused_step_kernel_warp<true> : (const void*)fused_step_kernel_warp<false>;
}
