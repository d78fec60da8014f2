// The auction's half builds (K4's Hungarian bf16 / f16 builds, K4 xl
// hungarian's and K12's): what auction.cuh's device functions need of a
// value type beyond its operators, for HV<H> (fp_half.cuh).  The values,
// prices and bids are half values held as their bits; fp::add / fp::sub
// compute in f32 and round once to the half dtype, which is what XLA's CPU
// code computes for the jnp auction (JAX ops/hungarian.py::auction_assign,
// :34) in bf16 and in f16 (it has no product to contract).  A half value
// widens to f32 exactly, so the warp's top two and the bid keys are the f32
// build's on the widened values.

#pragma once

// fp_half.cuh first: auction.cuh's templates call fp::add / fp::sub by
// qualified name, which finds only the overloads declared before them.
#include "fp_half.cuh"
#include "auction.cuh"

// The larger of two half values (top2_merge's second; no NaN reaches it).
template <class H>
__device__ __forceinline__ HV<H> fmax(HV<H> a, HV<H> b) {
  return a.f() >= b.f() ? a : b;
}

namespace motl_auction {

// The warp's top two of half values: the f32 one on the widened values.
template <class H>
__device__ __forceinline__ Top2<HV<H>> top2_warp(Top2<HV<H>> t) {
  const Top2<float> w = top2_warp(Top2<float>{t.v1.f(), t.i1, t.v2.f()});
  return {HV<H>(w.v1), w.i1, HV<H>(w.v2)};
}

// Host: the half builds' parameters from the wrapper's f32 array of half
// values [neg, neg_half, neg_pen, neg_pen2, eps_0, ...]
// (ops/hungarian.py::auction_schedule in the half dtype); false when out of
// range.
template <class H>
inline bool read_params_half(const float* f, int n_phases, int max_iters,
                             AuctionParams<HV<H>>* p) {
  if (f == nullptr || n_phases < 1 || n_phases > kMaxPhases) return false;
  HV<H> v[4 + kMaxPhases];
  for (int i = 0; i < 4 + n_phases; ++i) v[i] = HV<H>::raw(f[i]);
  return read_params(v, n_phases, max_iters, p);
}

}  // namespace motl_auction
