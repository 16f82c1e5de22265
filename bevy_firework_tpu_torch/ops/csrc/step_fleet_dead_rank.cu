// The step kernel's instantiations for fleet launches with the dead-rank claim
// (fused_step_kernel.cuh); bf_fused_step in fused_step.cu selects and launches
// them.

#include "fused_step_kernel.cuh"

extern "C" const void* bf_step_kernel_fleet_dead_rank(int collide, int fields, int stats) {
  return select_step_kernel<false, true>(collide != 0, fields != 0, stats != 0);
}
