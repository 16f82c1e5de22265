// The step kernel's instantiations for solo launches with the dead-rank claim
// (fused_step_kernel.cuh; hybrid frames' in step_merge.cu); bf_fused_step in fused_step.cu selects and launches
// them.

#include "fused_step_kernel.cuh"

extern "C" const void* bf_step_kernel_dead_rank(int collide, int fields, int stats) {
  return select_step_kernel<false, false>(collide != 0, fields != 0, stats != 0);
}
