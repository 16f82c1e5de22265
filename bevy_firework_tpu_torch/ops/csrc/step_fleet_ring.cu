// The step kernel's instantiations for fleet launches with the ring claim
// (fused_step_kernel.cuh); bf_fused_step in fused_step.cu selects and launches
// them.

#include "fused_step_kernel.cuh"

extern "C" const void* bf_step_kernel_fleet_ring(int collide, int fields, int stats) {
  return select_step_kernel<true, true>(collide != 0, fields != 0, stats != 0);
}
