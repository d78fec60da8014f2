// K12: the Hungarian auction alone, one warp (one CTA of 32 threads) per
// (D, K) problem, on given cost matrices.
//
// Runs the device function of K4's Hungarian builds (auction.cuh::
// auction_warp; its header says what it replaces -- the JAX package's
// jnp auction, multiple_object_tracking_lidar_tpu/ops/hungarian.py::
// auction_assign :34, no TPU kernel -- what bounds it and how) so that the
// auction can be held against its plain version by itself, max_iters small
// enough to saturate included.  No tracking path launches it: their
// auction is a stage of K4 (csrc/assign.cu), which rebuilds each cost from
// the detections and the slots' last positions instead of reading it.
// Here each value is read from the (D, K) cost and feasibility matrices in
// device memory (L1/L2-resident after the first iteration): -cost where
// feasible, NEG where not, as jnp.where writes it.
//
// Built for f32 (motl_auction_assign) and for bf16 / f16
// (motl_auction_assign_bf16 / _f16, dtype="bfloat16" / "float16"): the
// same kernel on HV<H> values (auction_half.cuh), reading the half cost
// matrices as they lie; the plain version runs the same auction on half
// tensors.

#include "auction_half.cuh"

namespace {

using motl_auction::AuctionParams;
using motl_auction::AuctionScratch;

constexpr int kMaxCols = 1024 + motl_auction::kMaxRows;

template <class T>
struct MatrixValue {
  const T* cost;
  const uint8_t* feas;
  int K;
  T neg;
  __device__ __forceinline__ T operator()(int r, int c) const {
    const size_t i = (size_t)r * K + c;
    return feas[i] ? -cost[i] : neg;
  }
};

template <class T>
__global__ void __launch_bounds__(32)
auction_kernel(const T* __restrict__ cost, const uint8_t* __restrict__ feas, int D, int K,
               AuctionParams<T> p, int* __restrict__ assigned, int* __restrict__ saturated,
               int* __restrict__ iters, int* __restrict__ fast) {
  __shared__ AuctionScratch<T, kMaxCols> sm;
  const size_t b = blockIdx.x;
  const MatrixValue<T> value{cost + b * D * K, feas + b * D * K, K, p.neg};
  motl_auction::auction_lists(value, D, K, p.neg, sm, 0, 1);
  __syncwarp();
  motl_auction::WideKeys<kMaxCols>* no_wide = nullptr;  // only the double build has a second step
  const int sat = motl_auction::auction_warp(
      value, D, K, p, sm, no_wide, iters != nullptr ? iters + b * p.n_phases : nullptr,
      fast != nullptr ? fast + b * p.n_phases : nullptr);
  for (int r = threadIdx.x; r < D; r += 32) {
    const int c = sm.row_col[r];
    assigned[b * D + r] = (c >= 0 && c < K) ? c : -1;
  }
  if (threadIdx.x == 0) saturated[b] = sat;
}

bool shape_ok(int B, int D, int K) {
  return B >= 1 && D >= 1 && D <= motl_auction::kMaxRows && K >= 1 && D + K <= kMaxCols;
}

template <class T>
int launch(const T* cost, const uint8_t* feas, const AuctionParams<T>& p, int B, int D, int K,
           int* assigned, int* saturated, int* iters, int* fast, void* stream) {
  auction_kernel<T><<<B, 32, 0, (cudaStream_t)stream>>>(cost, feas, D, K, p, assigned,
                                                         saturated, iters, fast);
  return (int)cudaGetLastError();
}

}  // namespace

// B problems: cost (B, D, K) f32, feas (B, D, K) u8; auction_f a HOST array
// [neg, neg_half, neg_pen, neg_pen2, eps_0, ..., eps_{n_phases - 1}] (f32,
// ops/hungarian.py::auction_schedule).  Outputs: assigned (B, D) i32 (the
// real column of each row, -1 if none), saturated (B,) i32, and, unless
// null, iters (B, n_phases) i32 and fast (B, n_phases) i32, each phase's
// iterations and those of them with no real row unassigned.  1 <= D <=
// 128, 1 <= K <= 1024.
extern "C" int motl_auction_assign(const float* cost, const uint8_t* feas, const float* auction_f,
                                   int n_phases, int max_iters, int B, int D, int K,
                                   int* assigned, int* saturated, int* iters, int* fast,
                                   void* stream) {
  AuctionParams<float> p;
  if (!shape_ok(B, D, K) || !motl_auction::read_params(auction_f, n_phases, max_iters, &p))
    return (int)cudaErrorInvalidValue;
  return launch(cost, feas, p, B, D, K, assigned, saturated, iters, fast, stream);
}

// The half builds: cost (B, D, K) bf16 / f16; auction_f the same f32 array
// holding the parameters as half values (auction_schedule in the half
// dtype; in f16 neg and neg_half are -inf); the rest as motl_auction_assign.
template <class H>
int auction_half(const typename H::storage* cost, const uint8_t* feas, const float* auction_f,
                 int n_phases, int max_iters, int B, int D, int K, int* assigned,
                 int* saturated, int* iters, int* fast, void* stream) {
  AuctionParams<HV<H>> p;
  if (!shape_ok(B, D, K) ||
      !motl_auction::read_params_half<H>(auction_f, n_phases, max_iters, &p))
    return (int)cudaErrorInvalidValue;
  return launch(reinterpret_cast<const HV<H>*>(cost), feas, p, B, D, K, assigned, saturated,
                iters, fast, stream);
}

extern "C" int motl_auction_assign_bf16(const __nv_bfloat16* cost, const uint8_t* feas,
                                        const float* auction_f, int n_phases, int max_iters,
                                        int B, int D, int K, int* assigned, int* saturated,
                                        int* iters, int* fast, void* stream) {
  return auction_half<fp::BF16>(cost, feas, auction_f, n_phases, max_iters, B, D, K, assigned,
                                saturated, iters, fast, stream);
}

extern "C" int motl_auction_assign_f16(const __half* cost, const uint8_t* feas,
                                       const float* auction_f, int n_phases, int max_iters,
                                       int B, int D, int K, int* assigned, int* saturated,
                                       int* iters, int* fast, void* stream) {
  return auction_half<fp::F16>(cost, feas, auction_f, n_phases, max_iters, B, D, K, assigned,
                               saturated, iters, fast, stream);
}
