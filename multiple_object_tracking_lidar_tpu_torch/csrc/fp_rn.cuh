// Correctly rounded f32 / f64 arithmetic under one name per operation, so a
// kernel templated on its float type (K2, K3f and K4's double builds)
// spells every product and sum once: float takes __fadd_rn / __fmul_rn /
// ..., double their __d*_rn twins.  Each op rounds on its own (nothing is
// contracted); fma is written only where the JAX package's CPU code
// contracts an FMA.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace fp {

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float sqrt(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float fma(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float rint(float a) { return rintf(a); }
__device__ __forceinline__ double rint(double a) { return ::rint(a); }

}  // namespace fp
