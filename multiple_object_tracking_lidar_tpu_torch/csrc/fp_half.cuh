// bf16 and f16 arithmetic as the JAX package's jitted CPU code computes it,
// for the half builds of K2, K14, K3f, K4, K6f and K8a (dtype="bfloat16" /
// "float16").  A half value lives in a float register (exactly: every
// bf16 and f16 value is an f32 value) and is read from and written to
// memory in its storage type.  Each op computes in f32 with the __f*_rn
// intrinsics and rounds the result once to the half type
// (__float2bfloat16_rn / __float2half_rn): f32 carries more than
// 2 * 11 + 2 bits, so +, -, *, / and sqrt rounded through f32 are the
// correctly rounded half ops XLA's code computes.  Where XLA's f16 code
// contracts a multiply into an add (``madd``), the f16 policy takes one FMA
// rounded once to f16 (formed in f64, where the product of two f16 values
// is exact; the plain versions' ops/half.py::madd); bf16 contracts nothing
// and rounds the product, then the sum.  A reduction, a dot or an einsum
// accumulates in f32 and rounds once (the kernels do that inline).
//
// Kept apart from fp_rn.cuh, which the host-side rehearsals of
// auction.cuh compile with g++ where the CUDA half headers do not exist.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>
#include <string.h>

#include "fp_rn.cuh"

namespace fp {

struct BF16 {
  using storage = __nv_bfloat16;
  static constexpr bool kDivByProduct = false;  // x / c stays a division
  static constexpr int kCountSat = 256;  // 0 + 1 + 1 + ... stops here (2^8 + 1 rounds to 2^8)
  static __device__ __forceinline__ float rnd(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ float load(storage x) { return __bfloat162float(x); }
  static __device__ __forceinline__ storage store(float x) { return __float2bfloat16_rn(x); }
  static __device__ __forceinline__ storage store_d(double x) { return __double2bfloat16(x); }
  static __device__ __forceinline__ unsigned short bits(storage x) {
    return __bfloat16_as_ushort(x);
  }
  static __device__ __forceinline__ storage from_bits(unsigned short b) {
    return __ushort_as_bfloat16(b);
  }
  // the bits of x, a bf16 value already (a host-side argument): its top half
  static __host__ unsigned short exact_bits(float x) {
    uint32_t u;
    memcpy(&u, &x, sizeof u);
    return (unsigned short)(u >> 16);
  }
  static __device__ __forceinline__ float madd(float a, float b, float c) {
    return rnd(__fadd_rn(rnd(__fmul_rn(a, b)), c));
  }
};

struct F16 {
  using storage = __half;
  static constexpr bool kDivByProduct = true;  // x / c is x * f16(1 / c) in XLA's f16 code
  static constexpr int kCountSat = 2048;  // a count summed in f16 stops at 2^11
  static __device__ __forceinline__ float rnd(float x) {
    return __half2float(__float2half_rn(x));
  }
  static __device__ __forceinline__ float load(storage x) { return __half2float(x); }
  static __device__ __forceinline__ storage store(float x) { return __float2half_rn(x); }
  static __device__ __forceinline__ storage store_d(double x) { return __double2half(x); }
  static __device__ __forceinline__ unsigned short bits(storage x) { return __half_as_ushort(x); }
  static __device__ __forceinline__ storage from_bits(unsigned short b) {
    return __ushort_as_half(b);
  }
  // the bits of x, an f16 value already (a host-side argument)
  static __host__ unsigned short exact_bits(float x) {
    uint32_t u;
    memcpy(&u, &x, sizeof u);
    const unsigned short sign = (unsigned short)((u >> 16) & 0x8000u);
    const uint32_t a = u & 0x7fffffffu;
    if (a >= 0x7f800000u) return sign | (a > 0x7f800000u ? 0x7e00u : 0x7c00u);
    if (a >= 0x38800000u)  // normal: the exponent rebiased, the top 10 mantissa bits
      return sign | (unsigned short)((((a >> 23) - 112u) << 10) | ((a >> 13) & 0x3ffu));
    float ax;  // subnormal or zero: ax = m * 2^-24, m < 1024
    memcpy(&ax, &a, sizeof ax);
    return sign | (unsigned short)(ax * 16777216.0f);
  }
  static __device__ __forceinline__ float madd(float a, float b, float c) {
    return __half2float(__double2half(__dadd_rn(__dmul_rn((double)a, (double)b), (double)c)));
  }
};

// the per-op half arithmetic of policy H on half values held in floats
template <class H> __device__ __forceinline__ float hadd(float a, float b) {
  return H::rnd(__fadd_rn(a, b));
}
template <class H> __device__ __forceinline__ float hsub(float a, float b) {
  return H::rnd(__fsub_rn(a, b));
}
template <class H> __device__ __forceinline__ float hmul(float a, float b) {
  return H::rnd(__fmul_rn(a, b));
}
template <class H> __device__ __forceinline__ float hdiv(float a, float b) {
  return H::rnd(__fdiv_rn(a, b));
}
template <class H> __device__ __forceinline__ float hsqrt(float a) {
  return H::rnd(__fsqrt_rn(a));
}

}  // namespace fp

// A half value of policy H as K4's half builds hold it: its bits in the
// half type, in memory (the builds read and write bf16 / f16 tensors) as in
// registers, computed in f32 and rounded by every op (fp::add, ... below),
// so that K4's templated body spells the per-op half arithmetic.  f()
// widens it (exactly); HV(x) rounds a float to it; raw() takes a float
// that is already a half value (host-side arguments).
template <class H>
struct HV {
  unsigned short b;
  HV() = default;
  __device__ explicit HV(float x) : b(H::bits(H::store(x))) {}
  __device__ explicit HV(double x) : HV((float)x) {}
  __device__ explicit HV(int x) : HV((float)x) {}
  static __host__ HV raw(float x) {
    HV h;
    h.b = H::exact_bits(x);
    return h;
  }
  __device__ __forceinline__ float f() const { return H::load(H::from_bits(b)); }
  __device__ explicit operator float() const { return f(); }
  __device__ explicit operator long long() const { return (long long)f(); }
  __device__ HV operator-() const { return HV(-f()); }
};
template <class H> __device__ __forceinline__ bool operator<(HV<H> a, HV<H> b) {
  return a.f() < b.f();
}
template <class H> __device__ __forceinline__ bool operator>(HV<H> a, HV<H> b) {
  return a.f() > b.f();
}
template <class H> __device__ __forceinline__ bool operator<=(HV<H> a, HV<H> b) {
  return a.f() <= b.f();
}
template <class H> __device__ __forceinline__ bool operator>=(HV<H> a, HV<H> b) {
  return a.f() >= b.f();
}
template <class H> __device__ __forceinline__ bool operator==(HV<H> a, HV<H> b) {
  return a.f() == b.f();
}
template <class H> __device__ __forceinline__ bool operator!=(HV<H> a, HV<H> b) {
  return a.f() != b.f();
}

namespace fp {

template <class H> __device__ __forceinline__ HV<H> add(HV<H> a, HV<H> b) {
  return HV<H>(__fadd_rn(a.f(), b.f()));
}
template <class H> __device__ __forceinline__ HV<H> sub(HV<H> a, HV<H> b) {
  return HV<H>(__fsub_rn(a.f(), b.f()));
}
template <class H> __device__ __forceinline__ HV<H> mul(HV<H> a, HV<H> b) {
  return HV<H>(__fmul_rn(a.f(), b.f()));
}
template <class H> __device__ __forceinline__ HV<H> div(HV<H> a, HV<H> b) {
  return HV<H>(__fdiv_rn(a.f(), b.f()));
}
template <class H> __device__ __forceinline__ HV<H> sqrt(HV<H> a) {
  return HV<H>(__fsqrt_rn(a.f()));
}
template <class H> __device__ __forceinline__ HV<H> fma(HV<H> a, HV<H> b, HV<H> c) {
  return HV<H>(H::madd(a.f(), b.f(), c.f()));
}
template <class H> __device__ __forceinline__ HV<H> rint(HV<H> a) { return HV<H>(rintf(a.f())); }

}  // namespace fp
