// Helpers shared by the port's kernels.
#pragma once

// min and max that propagate NaN, as jnp.minimum / jnp.maximum and
// torch.minimum / torch.maximum do (fminf / fmaxf drop a NaN operand).
// One instruction each on sm_80 and later.
__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
