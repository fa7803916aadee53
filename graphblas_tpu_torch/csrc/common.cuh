// Helpers shared by the port's kernels.
#pragma once

#include <stdint.h>

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

// The same in double, in software (PTX has no min.NaN.f64): a NaN operand
// gives NaN, and of two zeros -0.0 is the smaller.
__device__ __forceinline__ double min_nan(double a, double b) {
  if (a != a || b != b) return a + b;
  if (a == b) return __longlong_as_double(__double_as_longlong(a) | __double_as_longlong(b));
  return a < b ? a : b;
}

__device__ __forceinline__ double max_nan(double a, double b) {
  if (a != a || b != b) return a + b;
  if (a == b) return __longlong_as_double(__double_as_longlong(a) & __double_as_longlong(b));
  return a > b ? a : b;
}

// An L2 cache policy that marks lines evict-last (the random reads of a
// gather's source, kept resident while the streams pass through L2).
__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t pol;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(pol));
  return pol;
}

// p[0] through the read-only path, its line marked by the policy in L2.
__device__ __forceinline__ uint32_t ld_keep(const uint32_t* p, uint64_t pol) {
  uint32_t v;
  asm("ld.global.nc.L2::cache_hint.b32 %0, [%1], %2;" : "=r"(v) : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ uint16_t ld_keep(const uint16_t* p, uint64_t pol) {
  uint16_t v;
  asm("ld.global.nc.L2::cache_hint.b16 %0, [%1], %2;" : "=h"(v) : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ uint8_t ld_keep(const uint8_t* p, uint64_t pol) {
  uint16_t v;
  asm("ld.global.nc.L2::cache_hint.u8 %0, [%1], %2;" : "=h"(v) : "l"(p), "l"(pol));
  return (uint8_t)v;
}
