// The step kernel's instantiations for hybrid frames (kernel rows 9 and 10;
// solo launches, ring or dead-rank claim, with or without stats;
// fused_step_kernel.cuh): fused_step_kernel_merge for frames without
// colliders or force fields, fused_step_kernel's merge instantiations (the
// narrow phase and the field block compiled in) for the others. A source
// of their own, so the build compiles them beside the other shares;
// bf_fused_step in fused_step.cu selects and launches them.

#include "fused_step_kernel.cuh"

extern "C" const void* bf_step_kernel_merge(int ring, int lean, int stats) {
  if (lean) {
    if (ring)
      return stats ? (const void*)fused_step_kernel_merge<true, true> : (const void*)fused_step_kernel_merge<true, false>;
    return stats ? (const void*)fused_step_kernel_merge<false, true> : (const void*)fused_step_kernel_merge<false, false>;
  }
  if (ring)
    return stats ? (const void*)fused_step_kernel<true, true, true, true, true, false>
                 : (const void*)fused_step_kernel<true, true, true, false, true, false>;
  return stats ? (const void*)fused_step_kernel<false, true, true, true, true, false>
               : (const void*)fused_step_kernel<false, true, true, false, true, false>;
}
