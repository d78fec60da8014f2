// K4: the whole track step (greedy or Hungarian association, LPF or IHGP
// positions), one CTA per track bank, and its greedy decision scan alone.
//
// Replaces the Pallas kernel multiple_object_tracking_lidar_tpu/ops/
// assign_pallas.py::assoc_scan_pallas (body _kernel) and, around it, the
// rest of the JAX track_step (tracker/pipeline.py:942-1100), which XLA
// compiles into the same program.  Per frame, in order:
//
// 1. Decisions (device function `decide`, the scan the TPU kernel runs).
//    Detections are visited in order up to the last valid one + 1; each
//    gates the alive tracks with sqrt(dx^2 + dy^2) < thr, claims the gated
//    track with the smallest birth_seq (registration order), or registers
//    in the lowest free slot, or counts an overflow when the bank is full;
//    it writes the slot's last x / y / t, and flags the interpolation
//    backfill when the gap exceeds factor * dt.  Per detection: slot, id,
//    new, ok, interp (det_slot is defined only where det_ok,
//    assign_pallas.py:159-169); per track: alive, obj_id, birth_seq.
// 2. Window and carry updates, the closed form of ops/assign.py::
//    apply_window_updates: the slot's first detection backfills by linear
//    interpolation or fills the window on registration, the rest push in
//    arrival order, and a registration zeroes the slot's GP carry m0.
// 3. Duplicate handling: mult[k] counts the detections that updated slot k
//    this frame (when the frame publishes), and detection d's ordinal is
//    the number of those at or before d, less one.  Lane k runs mult[k]
//    chained IHGP velocity passes; detection d reads pass ordinal[d] of its
//    slot.  This is the loop the JAX package runs as a while_loop and the
//    plain version with one host sync per frame (max mult).
// 4. Output: the LPF position, the velocity clamp (NaN-preserving), expiry
//    of stale tracks every prune period, and every FrameOutput field.
//    Under position_filter="ihgp" (the kIhgp instantiations, the reference's
//    present-but-disabled mode, JAX tracker/pipeline.py:1015-1022) each
//    pass is two chained smoother passes: the position pass from the carry
//    over the window's xy less its last row (W_pos), then the velocity pass
//    from the position pass's carry; detection d publishes both from pass
//    ordinal[d].
//
// Under association="hungarian" (the kAuction instantiations; JAX
// tracker/pipeline.py:965-990 picks ops/hungarian.py::
// hungarian_associate_and_update) step 1 is the Hungarian stage instead
// (`hungarian_decide`): warp 0 runs the eps-scaling auction
// (auction.cuh::auction_warp) over the D detections and the K slots, each
// cost sqrt(fma(dx, dx, dy * dy)) rebuilt from the detections and the
// slots' last x / y in shared memory (a dead slot's last x / y NaN, so its
// gate fails as JAX's alive mask does), on the detections' lists of gated
// slots that every warp builds first, while the other warps wait; then
// lane k takes the detection that owns real column k (at most one), and the
// unmatched valid detections, in detection order, register into the free
// slots by rank, or count an overflow past the last free slot.  Steps 2-4
// are the same code as greedy's (every multiplicity is at most 1), and the
// frame's counts[3] is the auction's saturated phase count.  Each width
// and filter has its Hungarian build, so the greedy builds keep their
// registers and shared memory.  The half builds (bf16 / f16) have theirs
// too: the auction on half values (auction_half.cuh), as JAX runs
// hungarian_associate_and_update in the compute dtype.
//
// What bounds it on the H100: latency.  The scan is sequential over at
// most D <= 128 detections, a few dozen instructions each; the rest is a
// few hundred flops per updated track.  The bytes (the (K, L, 4) window at
// 40 KB for K = 64) take microseconds.  Before this kernel the step was
// ~100 small launches with one host sync per frame; the design makes it one
// launch per call with no sync.  One CTA of 32 * ceil(K / 32) threads per
// bank (blockIdx.x = stream), one lane per track slot.  The S frames of a
// call are scanned in order inside the CTA: each lane keeps its slot's
// summary (last x / y / t, alive, id, birth_seq) and GP carry in
// registers between frames; the window stays in global memory (655 KB at
// K = 1,024 and L = 40), each lane updating its own row in place
// (ascending rows: every shift reads a row ahead of the one it writes).
// The detections, the per-detection decisions and the smoother weights
// (W_vel's last rows Wy, Wm and the carries My, Mm; under ihgp W_pos's
// too) sit in shared memory.
// Each detection of the scan needs four block-wide reductions ("any gated",
// "smallest birth_seq among gated", "lowest free slot", "bank full"), done
// with warp shuffles plus one shared-memory exchange across the warps.
// Bounds: K <= 1,024 (one lane per slot, the largest CTA), D <= 128 (the
// shared detection buffer); past them K4 xl (below) runs the same step.
// The Hungarian builds' static shared memory
// (the auction's columns and lists, each slot's last x / y, the free-slot
// table) is ~48 KB at 1,024 lanes, at the static limit; their launch opts
// in to the dynamic shared memory (the smoother weights) past it.  Built for CTAs of up to 128 and of up to
// 1,024 threads: a 1,024-thread bound caps ptxas at 64 registers per
// thread, so banks of K <= 128 (the default K = 64) launch the 128-thread
// build and keep their registers.  Each width is built once per position
// filter (kIhgp): the ihgp pass's eight more live floats would otherwise
// add spills to the lpf path of the 1,024-thread build (measured: 4% more
// device time there).
//
// Arithmetic: every f32 product, sum and quotient is __fmul_rn /
// __fadd_rn / __fsub_rn / __fdiv_rn, each reduction ascending in its index
// and started from its first term, as the plain version spells it
// (ops/track_cuda.py), so the two agree bit for bit.  The distance uses
// IEEE sqrtf; the gap roundings use rintf (round half to even, as
// torch.round); int64 -> f32 conversions round to nearest.
//
// K4 xl (motl_track_step_xl, _xl_f64; track_step_xl_kernel): the same
// step at any K and D, every instantiation K4 has (greedy and Hungarian,
// lpf and ihgp, f32 and f64).  One CTA of up to 1,024 threads per bank, lane
// t owning slots t, t + blockDim.x, ...; the slots' summaries, the
// detections' flags and decisions in device memory (a scratch the wrapper
// allocates), the Hungarian tables sized for n = D + K columns at run time
// (shared memory while they fit).  Each reduction reduces a lane's own
// slots in ascending order before K4's warp and block reduction, and the
// per-slot code is K4's (slot_step), so its results are K4's bit for bit
// where both run.  What bounds it: as K4, latency -- the scan's barriers per
// detection, and under hungarian the auction's iterations, at least K per
// phase (3,000 at the cap), on one warp (auction.cuh says how).  The
// narrow builds stay as they are for the sizes they hold.
//
// Double builds (motl_track_step_f64, dtype="float64"): the same kernel
// templated on the float type T of the detections, windows, carries and
// smoother weights, each op its __d*_rn twin (fp_rn.cuh), the Hungarian
// gate's FMA __fma_rn; the JAX package runs its track step in the compute
// dtype (tracker/pipeline.py:942-1100) and the plain version is the same
// torch code on f64 tensors.  Every double build is one launch per call.
// The Hungarian double builds keep their auction tables (prices, bids, the
// second step's rows; ~62 KB at 1,024 lanes, past the 48 KB of static shared
// memory) in dynamic shared memory after the smoother weights
// (`hungarian_smem`), so they hold the f32 builds' K <= 1,024.

#include <cuda_runtime.h>
#include <stdint.h>

#include "auction_half.cuh"
#include "fp_half.cuh"
#include "fp_rn.cuh"

namespace {

using motl_auction::kFull;

// A window row (x, y, z, t), aligned as float4 in the f32 builds so that a
// row is one 16-byte access
template <class T>
struct alignas(4 * sizeof(T)) V4 {
  T x, y, z, w;
};

// The smoother's sums, its mean and the divisions by dt, per float type:
// the f32 / f64 builds in the type itself, ascending from the first term
// (the ops the kernel always spelled); the half builds (HV, fp_half.cuh)
// as XLA's CPU code computes the JAX track step in bf16 / f16
// (ops/half.py, the plain version's ops/track_cuda.py::_wsum,
// mean_f32, smoother_parts, ops/voxel.py::true_div, models/lpf.py): exact
// products summed in f32 and rounded once, the mean that sum times
// f32(1 / n), a division by dt the product by dt's reciprocal (f16: rounded
// to f16; bf16: an f32 product by the f32 reciprocal), the LPF in f16 one
// contracted multiply-add.
template <class T>
struct Arith {
  using A = T;
  static __device__ __forceinline__ A lift(T x) { return x; }
  static __device__ __forceinline__ A mul(T a, T b) { return fp::mul(a, b); }
  static __device__ __forceinline__ A add(A a, A b) { return fp::add(a, b); }
  static __device__ __forceinline__ T fin(A a) { return a; }
  static __device__ __forceinline__ T mean(A s, int n) { return fp::div(s, (T)n); }
  static __device__ __forceinline__ T div_dt(T x, T dt) { return fp::div(x, dt); }
  // a window velocity as the mean's sum takes it; one less the mean; the
  // backfill's time last + jj * dt
  static __device__ __forceinline__ A vel_term(T diff, T dt) { return fp::div(diff, dt); }
  static __device__ __forceinline__ T centred(T diff, T dt, T mean) {
    return fp::sub(fp::div(diff, dt), mean);
  }
  static __device__ __forceinline__ T tstep(T last, T jj, T dt) {
    return fp::add(last, fp::mul(jj, dt));
  }
  static __device__ __forceinline__ T dot2(T a0, T b0, T a1, T b1) {
    return fp::add(fp::mul(a0, b0), fp::mul(a1, b1));
  }
  static __device__ __forceinline__ T lpf(T a, T w2, T b, T w1) {
    return fp::add(fp::mul(a, w2), fp::mul(b, w1));
  }
};

template <class H>
struct Arith<HV<H>> {
  using T = HV<H>;
  using A = float;
  static __device__ __forceinline__ A lift(T x) { return x.f(); }
  static __device__ __forceinline__ A mul(T a, T b) { return __fmul_rn(a.f(), b.f()); }
  static __device__ __forceinline__ A add(A a, A b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ T fin(A a) { return T(a); }
  static __device__ __forceinline__ T mean(A s, int n) {
    return T(__fmul_rn(s, __double2float_rn(__ddiv_rn(1.0, (double)n))));
  }
  // f16: x times dt's f16 reciprocal, rounded; bf16: x times dt's f32
  // reciprocal, rounded (XLA's folds of x / dt, ops/voxel.py::true_div)
  static __device__ __forceinline__ float recip(T dt) {
    if constexpr (H::kDivByProduct) return H::load(H::store_d(__ddiv_rn(1.0, (double)dt.f())));
    return __fdiv_rn(1.0f, dt.f());
  }
  static __device__ __forceinline__ T div_dt(T x, T dt) { return T(__fmul_rn(x.f(), recip(dt))); }
  // the mean's terms: f16 the rounded velocities, bf16 their f32 products
  // before the rounding (XLA keeps them in the reduction's fusion)
  static __device__ __forceinline__ A vel_term(T diff, T dt) {
    if constexpr (H::kDivByProduct) return div_dt(diff, dt).f();
    return __fmul_rn(diff.f(), recip(dt));
  }
  // f16 contracts the velocity's product into its centring and the
  // backfill's jj * dt into last + (XLA's f16 FMAs); bf16 rounds each op
  static __device__ __forceinline__ T centred(T diff, T dt, T mean) {
    if constexpr (H::kDivByProduct) return T(H::madd(diff.f(), recip(dt), -mean.f()));
    return fp::sub(div_dt(diff, dt), mean);
  }
  static __device__ __forceinline__ T tstep(T last, T jj, T dt) {
    if constexpr (H::kDivByProduct) return T(H::madd(jj.f(), dt.f(), last.f()));
    return fp::add(last, fp::mul(jj, dt));
  }
  static __device__ __forceinline__ T dot2(T a0, T b0, T a1, T b1) {
    return fin(add(mul(a0, b0), mul(a1, b1)));
  }
  static __device__ __forceinline__ T lpf(T a, T w2, T b, T w1) {
    return T(H::madd(w2.f(), a.f(), fp::hmul<H>(b.f(), w1.f())));
  }
};

__device__ __forceinline__ void i2f(long long v, float& out);
template <class H>
__device__ __forceinline__ void i2f(long long v, HV<H>& out) {
  out = HV<H>(__ll2float_rn(v));
}

constexpr int kMaxDets = 128;
constexpr int kMaxLanes = 1024;
constexpr int kNarrowLanes = 128;  // the TPU kernel's K bound
constexpr int kBig = 1 << 30;

template <class T>
struct Selected {
  int slot;
  T t;
  int id;
};

// One lane's view of its track slot during the scan.
template <class T>
struct Lane {
  T lx, ly, lt;
  int alive, oid, birth;
};

// Per-detection decisions in shared memory.
struct Decisions {
  int slot[kMaxDets];
  int id[kMaxDets];
  int is_new[kMaxDets];
  int ok[kMaxDets];
  int interp[kMaxDets];
};

template <class T, int kLanes>
struct ScanScratch {
  int red[2][4][kLanes / 32];
  Selected<T> sel[2];
};

__device__ __forceinline__ int last_valid_bound(const int* s_dv, int D) {
  int bound = 0;
  for (int d = 0; d < D; ++d)
    if (s_dv[d]) bound = d + 1;
  return bound;
}

// The per-detection decisions of K4 xl, in device memory (D entries each):
// indexed as Decisions's arrays.
struct DecisionsXl {
  int* slot;
  int* id;
  int* is_new;
  int* ok;
  int* interp;
};

// Decision defaults for every detection: slot 0, id -1, flags off.
template <class R>
__device__ __forceinline__ void decision_defaults(R& r, int D) {
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    r.slot[d] = 0;
    r.id[d] = -1;
    r.is_new[d] = 0;
    r.ok[d] = 0;
    r.interp[d] = 0;
  }
}

// The greedy scan over detections [0, bound).  Every thread of the CTA
// calls it; lane k (k < K) owns slot k.  Ends with a barrier, so `r` is
// complete for every thread on return.
template <class T, int kLanes>
__device__ void decide(const T* s_det, const int* s_dv, int bound, bool allow,
                       T thr, T gapthr, T dt, int K, Lane<T>& me,
                       int& nobj, int& nbirth, int& ovf, ScanScratch<T, kLanes>& sc,
                       Decisions& r) {
  const int k = threadIdx.x;
  const int lane = k & 31, warp = k >> 5;
  const int n_warps = blockDim.x >> 5;
  const bool in_k = k < K;
  for (int j = 0; j < bound; ++j) {
    const T d0 = s_det[4 * j], d1 = s_det[4 * j + 1], d3 = s_det[4 * j + 3];
    const bool valid = s_dv[j] != 0;
    const bool is_alive = in_k && me.alive > 0;
    const T dx = fp::sub(d0, me.lx), dy = fp::sub(d1, me.ly);
    const T dist = fp::sqrt(fp::add(fp::mul(dx, dx), fp::mul(dy, dy)));
    const bool gate = is_alive && dist < thr && allow;
    const bool is_free = in_k && !is_alive;
    int r_any = gate ? 1 : 0;
    int r_bmin = gate ? me.birth : kBig;
    int r_fmin = is_free ? k : kBig;
    int r_full = (is_alive || !in_k) ? 1 : 0;
    for (int o = 16; o > 0; o >>= 1) {
      r_any |= __shfl_xor_sync(0xffffffffu, r_any, o);
      r_bmin = min(r_bmin, __shfl_xor_sync(0xffffffffu, r_bmin, o));
      r_fmin = min(r_fmin, __shfl_xor_sync(0xffffffffu, r_fmin, o));
      r_full &= __shfl_xor_sync(0xffffffffu, r_full, o);
    }
    // Shared scratch is double-buffered by trip parity, so two barriers per
    // trip suffice: a buffer is rewritten two trips later, after every
    // thread has passed the next trip's first barrier (and so has finished
    // reading it).
    const int buf = j & 1;
    if (k == 0) {  // defaults for "no slot selected" (full bank, no match)
      sc.sel[buf].slot = 0;
      sc.sel[buf].t = T(0);
      sc.sel[buf].id = 0;
    }
    if (lane == 0) {
      sc.red[buf][0][warp] = r_any;
      sc.red[buf][1][warp] = r_bmin;
      sc.red[buf][2][warp] = r_fmin;
      sc.red[buf][3][warp] = r_full;
    }
    __syncthreads();
    int any = 0, bmin = kBig, fmin = kBig, full = 1;
    for (int w = 0; w < n_warps; ++w) {
      any |= sc.red[buf][0][w];
      bmin = min(bmin, sc.red[buf][1][w]);
      fmin = min(fmin, sc.red[buf][2][w]);
      full &= sc.red[buf][3][w];
    }
    const bool am = any != 0;
    const bool bank_full = full != 0;
    // the selected lane is unique: min birth_seq among gated (births are
    // unique among alive tracks), else the first free slot
    const bool sel = am ? (gate && me.birth == bmin) : (is_free && k == fmin);
    if (sel) {
      sc.sel[buf].slot = k;
      sc.sel[buf].t = me.lt;
      sc.sel[buf].id = me.oid;
    }
    __syncthreads();
    const int sel_slot = sc.sel[buf].slot;
    const T t_slot = sc.sel[buf].t;
    const int id_slot = sc.sel[buf].id;
    const T gap = fp::sub(d3, t_slot);
    const bool do_interp =
        am && gap > gapthr && fp::sub(fp::rint(Arith<T>::div_dt(gap, dt)), T(1)) >= T(1);
    const bool reg = valid && !am && !bank_full;
    const bool matched = valid && am;
    const bool write = matched || reg;
    if (sel && write) {
      me.lx = d0;
      me.ly = d1;
      me.lt = d3;
    }
    if (sel && reg) {
      me.alive = 1;
      me.oid = nobj;
      me.birth = nbirth;
    }
    if (k == 0) {
      r.slot[j] = sel_slot;
      r.id[j] = matched ? id_slot : (reg ? nobj : -1);
      r.is_new[j] = reg ? 1 : 0;
      r.ok[j] = write ? 1 : 0;
      r.interp[j] = (do_interp && write) ? 1 : 0;
    }
    nobj += reg ? 1 : 0;
    nbirth += reg ? 1 : 0;
    ovf += (valid && !am && bank_full) ? 1 : 0;
  }
  __syncthreads();
}

template <int kLanes>
__global__ void __launch_bounds__(kLanes)
assoc_scan_kernel(const float* __restrict__ af0, const int* __restrict__ ai0,
                  const float* __restrict__ dets, const uint8_t* __restrict__ dv,
                  const int* __restrict__ allow_p, const int* __restrict__ cnt_in,
                  int K, int D, float thr, float gapthr, float dt,
                  int* __restrict__ ai_out, int* __restrict__ outs,
                  int* __restrict__ cnt_out) {
  __shared__ float s_det[kMaxDets * 4];
  __shared__ int s_dv[kMaxDets];
  __shared__ Decisions s_res;
  __shared__ ScanScratch<float, kLanes> s_sc;
  const int k = threadIdx.x;
  const bool in_k = k < K;
  Lane<float> me = {0.f, 0.f, 0.f, 0, 0, 0};
  if (in_k) {
    me.lx = af0[3 * k];
    me.ly = af0[3 * k + 1];
    me.lt = af0[3 * k + 2];
    me.alive = ai0[3 * k];
    me.oid = ai0[3 * k + 1];
    me.birth = ai0[3 * k + 2];
  }
  for (int d = k; d < D; d += blockDim.x) {
    for (int q = 0; q < 4; ++q) s_det[4 * d + q] = dets[4 * d + q];
    s_dv[d] = dv[d] != 0;
  }
  decision_defaults(s_res, D);
  int nobj = cnt_in[0], nbirth = cnt_in[1], ovf = 0;
  __syncthreads();
  const int bound = last_valid_bound(s_dv, D);
  decide<float, kLanes>(s_det, s_dv, bound, allow_p[0] != 0, thr, gapthr, dt, K, me, nobj,
                        nbirth, ovf, s_sc, s_res);
  for (int d = k; d < D; d += blockDim.x) {
    outs[d] = s_res.slot[d];
    outs[D + d] = s_res.id[d];
    outs[2 * D + d] = s_res.is_new[d];
    outs[3 * D + d] = s_res.ok[d];
    outs[4 * D + d] = s_res.interp[d];
  }
  if (in_k) {
    ai_out[3 * k] = me.alive;
    ai_out[3 * k + 1] = me.oid;
    ai_out[3 * k + 2] = me.birth;
  }
  if (k == 0) {
    cnt_out[0] = nobj;
    cnt_out[1] = nbirth;
    cnt_out[2] = ovf;
  }
}

// ---------------------------------------------------------------------------
// the whole track step
// ---------------------------------------------------------------------------
template <class T>
struct TrackArgs {
  const T* dets;          // (B, S, D, 4)
  const uint8_t* dv;      // (B, S, D)
  const T* t;             // (B, S)
  const uint8_t* alive_in;  // (B, K)
  const int* oid_in;
  const int* birth_in;
  const T* win_in;        // (B, K, L, 4)
  const T* m0_in;         // (B, K, 2, 2)
  const int* nobj_in;     // (B,)
  const int* nbirth_in;
  const int* spin_in;
  const uint8_t* init_in;
  const T* wy;            // W_vel Wy (2, L-1, L-1): row L-2 is eft's
  const T* wm;            // W_vel Wm (2, L-1, 2): row L-2
  const T* my;            // W_vel My (2, 2, L-1)
  const T* mm;            // W_vel Mm (2, 2, 2)
  const T* pwy;           // W_pos Wy (2, L, L): row L-1 is eft's (read under ihgp)
  const T* pwm;           // W_pos Wm (2, L, 2): row L-1
  const T* pmy;           // W_pos My (2, 2, L)
  const T* pmm;           // W_pos Mm (2, 2, 2)
  int S, K, D, L;
  T thr, gapthr, dt, vmax, lpf_a, lpf_b, prune_period;
  int prune_spin;
  uint8_t* alive_out;
  int* oid_out;
  int* birth_out;
  T* win_out;
  T* m0_out;
  int* nobj_out;
  int* nbirth_out;
  int* spin_out;
  uint8_t* init_out;
  uint8_t* publish;       // (B, S)
  uint8_t* valid;         // (B, S, D)
  int* obj_id;            // (B, S, D)
  T* pos;                 // (B, S, D, 2)
  T* vel;                 // (B, S, D, 2)
  uint8_t* new_track;     // (B, S, D)
  int* counts;            // (B, S, 4): n_alive, overflow, dup_saturated, assoc_saturated
  motl_auction::AuctionParams<T> au;  // read by the Hungarian builds
  void* stream;
};

// ---------------------------------------------------------------------------
// the Hungarian stage
// ---------------------------------------------------------------------------
template <class T>
struct XY {
  T x, y;
};

template <class T, int kLanes>
struct HungarianScratch {
  motl_auction::AuctionScratch<T, kLanes + kMaxDets> auc;
  XY<T> last[kLanes];     // each slot's last x / y; NaN where the slot is not alive
  int free_slot[kLanes];  // the q-th free slot (before this frame's registrations)
  int reg_det[kMaxDets];  // the detection registered into the q-th free slot
  int sat;
  int n_want;
};

// The double builds' second-step auction scratch (none in the f32 and half
// builds).
template <class T, int kLanes>
struct WideScratch {};
template <int kLanes>
struct WideScratch<double, kLanes> {
  motl_auction::WideKeys<kLanes + kMaxDets> keys;
};

// Bytes of the smoother weights in dynamic shared memory (W_vel's, and
// W_pos's under ihgp), rounded up to 16 so that what follows is aligned.
template <class T>
__host__ __device__ inline size_t weights_smem(int L, bool ihgp) {
  const size_t b = (size_t)(6 * (L - 1) + 4 + 8 + (ihgp ? 6 * L + 4 + 8 : 0)) * sizeof(T);
  return (b + 15) & ~(size_t)15;
}

// The double Hungarian builds' scratch in dynamic shared memory after the
// weights; the f32 builds keep theirs static (none here).
template <class T, int kLanes, bool kAuction>
inline size_t hungarian_smem() {
  if (kAuction && sizeof(T) == sizeof(double))
    return sizeof(HungarianScratch<T, kLanes>) + sizeof(WideScratch<T, kLanes>) + 16;
  return 0;
}

// A detection's value on a slot: -cost where gated (valid, allowed, cost <
// thr), else NEG; the cost sqrt(fma(dx, dx, dy * dy)), as XLA's CPU code
// contracts the JAX expression (tests/test_torch_hungarian.py).  In the half
// builds fp::fma is H::madd: f16 one FMA rounded once (bind_env's program
// computes vfmadd231sh, then vsqrtsh), bf16 the square rounded, then the
// sum, then the f32 root, each rounded to bf16 (ops/hungarian.py::gate_costs).
template <class T>
struct TrackValue {
  const T* det;
  const int* dv;
  const XY<T>* last;
  bool allow;
  T thr, neg;
  __device__ __forceinline__ T operator()(int r, int c) const {
    const T dx = fp::sub(det[4 * r], last[c].x), dy = fp::sub(det[4 * r + 1], last[c].y);
    const T cost = fp::sqrt(fp::fma(dx, dx, fp::mul(dy, dy)));
    return (dv[r] && allow && cost < thr) ? -cost : neg;
  }
};

// The Hungarian decisions over all D detections (JAX ops/hungarian.py:
// 139-200): the auction, then matches and registrations.  Every thread of
// the CTA calls it; lane k (k < K) owns slot k.  s_wcount holds a count per
// warp.  Ends with a barrier, so `r` is complete for every thread on return;
// nobj, nbirth, ovf and sat come out the same in every thread.
template <class T, int kLanes>
__device__ void hungarian_decide(const T* s_det, const int* s_dv, bool allow, T thr,
                                 T gapthr, T dt, int K, int D,
                                 const motl_auction::AuctionParams<T>& au, Lane<T>& me,
                                 int& nobj, int& nbirth, int& ovf, int& sat, int* s_wcount,
                                 HungarianScratch<T, kLanes>& h, WideScratch<T, kLanes>& wide,
                                 Decisions& r) {
  const int k = threadIdx.x;
  const int lane = k & 31, warp = k >> 5;
  const int n_warps = blockDim.x >> 5;
  const bool in_k = k < K;
  const unsigned below = (1u << lane) - 1u;
  if (in_k) {
    const T nan = T(NAN);
    h.last[k] = me.alive ? XY<T>{me.lx, me.ly} : XY<T>{nan, nan};
  }
  __syncthreads();
  const TrackValue<T> value{s_det, s_dv, h.last, allow, thr, au.neg};
  motl_auction::auction_lists(value, D, K, au.neg, h.auc, warp, n_warps);
  __syncthreads();
  if (warp == 0) {
    motl_auction::WideKeys<kLanes + kMaxDets>* wk = nullptr;
    if constexpr (sizeof(T) == sizeof(double)) wk = &wide.keys;
    const int s = motl_auction::auction_warp(value, D, K, au, h.auc, wk, nullptr);
    if (lane == 0) h.sat = s;
  }
  __syncthreads();
  sat = h.sat;
  // a match: the detection owning real column k, with the pre-frame slot's
  // id and last t (the interpolation test)
  const int own = in_k ? h.auc.owner[k] : -1;
  if (own >= 0 && own < D) {
    const T t_det = s_det[4 * own + 3];
    const T gap = fp::sub(t_det, me.lt);
    r.slot[own] = k;
    r.id[own] = me.oid;
    r.ok[own] = 1;
    r.interp[own] =
        (gap > gapthr && fp::sub(fp::rint(Arith<T>::div_dt(gap, dt)), T(1)) >= T(1)) ? 1 : 0;
    me.lx = s_det[4 * own];
    me.ly = s_det[4 * own + 1];
    me.lt = t_det;
  }
  // the free slots' ranks (slot order)
  const bool free_k = in_k && !me.alive;
  const unsigned fb = __ballot_sync(kFull, free_k);
  if (lane == 0) s_wcount[warp] = __popc(fb);
  __syncthreads();
  int rank = __popc(fb & below), n_free = 0;
  for (int w = 0; w < n_warps; ++w) {
    const int c = s_wcount[w];
    rank += w < warp ? c : 0;
    n_free += c;
  }
  if (free_k) h.free_slot[rank] = k;
  __syncthreads();
  // registrations: the unmatched valid detections, in order, take the free
  // slots by rank
  if (warp == 0) {
    int cnt = 0;
    for (int base = 0; base < D; base += 32) {
      const int d = base + lane;
      const int col = d < D ? h.auc.row_col[d] : -1;
      const bool want = d < D && s_dv[d] && !(col >= 0 && col < K);
      const unsigned wb = __ballot_sync(kFull, want);
      const int q = cnt + __popc(wb & below);
      if (want && q < n_free) {
        r.slot[d] = h.free_slot[q];
        r.id[d] = nobj + q;
        r.is_new[d] = 1;
        r.ok[d] = 1;
        h.reg_det[q] = d;
      }
      cnt += __popc(wb);
    }
    if (lane == 0) h.n_want = cnt;
  }
  __syncthreads();
  const int n_want = h.n_want, n_reg = min(n_want, n_free);
  if (free_k && rank < n_reg) {
    const int d = h.reg_det[rank];
    me.alive = 1;
    me.oid = nobj + rank;
    me.birth = nbirth + rank;
    me.lx = s_det[4 * d];
    me.ly = s_det[4 * d + 1];
    me.lt = s_det[4 * d + 3];
  }
  nobj += n_reg;
  nbirth += n_reg;
  ovf += n_want - n_reg;
}

// int64 -> T, round to nearest (torch's .to(float32 / float64) of an int64)
__device__ __forceinline__ void i2f(long long v, float& out) { out = __ll2float_rn(v); }
__device__ __forceinline__ void i2f(long long v, double& out) { out = __ll2double_rn(v); }

// Lane k's window row after this frame's decisions, in place: the first
// detection's interpolation backfill or registration fill, then the pushes
// in arrival order (ops/assign.py::apply_window_updates, _interp_backfill).
template <class T, class R>
__device__ void update_window(V4<T>* w, int L, const T* s_det, const R& r, int D, int k,
                              T dt) {
  int mult = 0, first = -1;
  for (int d = 0; d < D; ++d) {
    if (r.ok[d] && r.slot[d] == k) {
      if (first < 0) first = d;
      ++mult;
    }
  }
  if (mult == 0) return;
  const V4<T> d1 = {s_det[4 * first], s_det[4 * first + 1], s_det[4 * first + 2],
                    s_det[4 * first + 3]};
  const bool first_reg = r.is_new[first] != 0;
  if (first_reg) {
    for (int l = 0; l < L; ++l) w[l] = d1;
  } else if (r.interp[first]) {
    const V4<T> last = w[L - 1];
    const T gap = fp::sub(d1.w, last.w);
    const long long lost = (long long)fp::rint(Arith<T>::div_dt(gap, dt)) - 1;
    const long long lost_c = lost < 1 ? 1 : lost;
    T lc;
    i2f(lost_c, lc);
    const T sx = fp::div(fp::sub(d1.x, last.x), lc);
    const T sy = fp::div(fp::sub(d1.y, last.y), lc);
    const T sz = fp::div(fp::sub(d1.z, last.z), lc);
    for (int l = 0; l < L; ++l) {
      if ((long long)l + lost < L) {
        w[l] = w[l + lost];
      } else {
        T jj;
        i2f((long long)l - L + lost_c + 1, jj);
        w[l] = V4<T>{fp::add(last.x, fp::mul(fp::mul(jj, sx), T(1))),
                     fp::add(last.y, fp::mul(fp::mul(jj, sy), T(1))),
                     fp::add(last.z, fp::mul(fp::mul(jj, sz), T(0))),
                     Arith<T>::tstep(last.w, jj, dt)};
      }
    }
  }
  // pushes: every assigned detection but the first when it registered
  const int n_push = first_reg ? mult - 1 : mult;
  const int offset = first_reg ? 1 : 0;
  // shift by n_push rows, eight rows loaded before any is stored: a chunk
  // reads rows at or past l0 + n_push >= l0 + 1, which no earlier chunk
  // overwrote
  if (n_push > 0) {
    for (int l0 = 0; l0 + n_push < L; l0 += 8) {
      const int m = min(8, L - n_push - l0);
      V4<T> tmp[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (j < m) tmp[j] = w[l0 + j + n_push];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (j < m) w[l0 + j] = tmp[j];
    }
  }
  int j = 0;
  for (int d = first; d < D; ++d) {
    if (!(r.ok[d] && r.slot[d] == k)) continue;
    const int row = j - offset + L - n_push;
    if (j >= offset && row >= 0)
      w[row] = V4<T>{s_det[4 * d], s_det[4 * d + 1], s_det[4 * d + 2], s_det[4 * d + 3]};
    ++j;
  }
}

// The smoother weights in dynamic shared memory: W_vel's wy_last (2, L-1),
// wm_last (2, 2), my (2, 2, L-1), mm (2, 2, 2); then under ihgp W_pos's
// wy_last (2, L), wm_last (2, 2), my (2, 2, L), mm (2, 2, 2).
template <class T>
struct Weights {
  const T *wy, *wm, *my, *mm, *pwy, *pwm, *pmy, *pmm;
};

// Every thread of the CTA copies its share of the weights into s_w.
template <class T, bool kIhgp>
__device__ __forceinline__ Weights<T> load_weights(const TrackArgs<T>& a, T* s_w) {
  const int k = threadIdx.x;
  const int L = a.L, L1 = L - 1;
  T* wy = s_w;
  T* wm = wy + 2 * L1;
  T* my = wm + 4;
  T* mm = my + 4 * L1;
  for (int i = k; i < 2 * L1; i += blockDim.x) {
    const int ax = i / L1, l = i % L1;
    wy[i] = a.wy[((size_t)ax * L1 + (L1 - 1)) * L1 + l];
  }
  for (int i = k; i < 4; i += blockDim.x) wm[i] = a.wm[((i >> 1) * L1 + (L1 - 1)) * 2 + (i & 1)];
  for (int i = k; i < 4 * L1; i += blockDim.x) my[i] = a.my[i];
  for (int i = k; i < 8; i += blockDim.x) mm[i] = a.mm[i];
  T* pwy = mm + 8;
  T* pwm = pwy + 2 * L;
  T* pmy = pwm + 4;
  T* pmm = pmy + 4 * L;
  if constexpr (kIhgp) {
    for (int i = k; i < 2 * L; i += blockDim.x) {
      const int ax = i / L, l = i % L;
      pwy[i] = a.pwy[((size_t)ax * L + (L - 1)) * L + l];
    }
    for (int i = k; i < 4; i += blockDim.x)
      pwm[i] = a.pwm[((i >> 1) * L + (L - 1)) * 2 + (i & 1)];
    for (int i = k; i < 4 * L; i += blockDim.x) pmy[i] = a.pmy[i];
    for (int i = k; i < 8; i += blockDim.x) pmm[i] = a.pmm[i];
  }
  return {wy, wm, my, mm, pwy, pwm, pmy, pmm};
}

// Slot k's step after the frame's decisions (r) and active flags (act):
// its window row updated in place, its GP carry m zeroed on registration,
// then the chained passes its detections ask for, each writing the
// detection's pos / vel of frame fs -- K4's per-slot code (track_step_kernel
// below), for K4 xl.  K4's narrow builds keep their own copy: calling this
// from them cost 2.1% of their device time (63.88 -> 65.23 us at the
// headline, in turns with the parent).
template <class T, bool kIhgp, class R>
__device__ __forceinline__ void slot_step(const TrackArgs<T>& a, const Weights<T>& wt, V4<T>* w,
                                          T (&m)[2][2], int k, const T* s_det, const R& r,
                                          const int* act, size_t fs) {
  const int D = a.D, L = a.L, L1 = L - 1;
  update_window(w, L, s_det, r, D, k, a.dt);
  // a registration zeroes the slot's GP carry (the ctor, cpp:45)
  for (int d = 0; d < D; ++d) {
    if (r.is_new[d] && r.slot[d] == k) {
      m[0][0] = m[0][1] = m[1][0] = m[1][1] = T(0);
    }
  }
  int mult = 0;
  for (int d = 0; d < D; ++d) mult += (act[d] && r.slot[d] == k) ? 1 : 0;
  if (mult == 0) return;
  const T *wy = wt.wy, *wm = wt.wm, *my = wt.my, *mm = wt.mm;
  // velocity window, its mean, the y-parts of the smoother sums and the
  // LPF position: once per frame, ascending in the window index (each row
  // read once per pass, both axes together; unrolled so the row loads
  // overlap)
  T vmean[2], ey[2], myv[2][2];
  typename Arith<T>::A sum[2], eyA[2], myvA[2][2];
  XY<T> prev = {w[0].x, w[0].y};
#pragma unroll 8
  for (int l = 0; l < L1; ++l) {
    const V4<T> cur = w[l + 1];
    const auto vx = Arith<T>::vel_term(fp::sub(cur.x, prev.x), a.dt);
    const auto vy = Arith<T>::vel_term(fp::sub(cur.y, prev.y), a.dt);
    sum[0] = l ? Arith<T>::add(sum[0], vx) : vx;
    sum[1] = l ? Arith<T>::add(sum[1], vy) : vy;
    prev = XY<T>{cur.x, cur.y};
  }
  vmean[0] = Arith<T>::mean(sum[0], L1);
  vmean[1] = Arith<T>::mean(sum[1], L1);
  prev = XY<T>{w[0].x, w[0].y};
#pragma unroll 8
  for (int l = 0; l < L1; ++l) {
    const V4<T> cur = w[l + 1];
    const T yv[2] = {
        Arith<T>::centred(fp::sub(cur.x, prev.x), a.dt, vmean[0]),
        Arith<T>::centred(fp::sub(cur.y, prev.y), a.dt, vmean[1])};
    prev = XY<T>{cur.x, cur.y};
#pragma unroll
    for (int ax = 0; ax < 2; ++ax) {
      const auto e = Arith<T>::mul(yv[ax], wy[ax * L1 + l]);
      const auto c0 = Arith<T>::mul(yv[ax], my[(ax * 2 + 0) * L1 + l]);
      const auto c1 = Arith<T>::mul(yv[ax], my[(ax * 2 + 1) * L1 + l]);
      eyA[ax] = l ? Arith<T>::add(eyA[ax], e) : e;
      myvA[ax][0] = l ? Arith<T>::add(myvA[ax][0], c0) : c0;
      myvA[ax][1] = l ? Arith<T>::add(myvA[ax][1], c1) : c1;
    }
  }
  for (int ax = 0; ax < 2; ++ax) {
    ey[ax] = Arith<T>::fin(eyA[ax]);
    myv[ax][0] = Arith<T>::fin(myvA[ax][0]);
    myv[ax][1] = Arith<T>::fin(myvA[ax][1]);
  }
  // the position: LPF once per frame, or under ihgp the y-parts of the
  // position smoother (pmean = the last row's xy, y_l = row l's xy less
  // pmean), ascending in l, and a position pass per pass
  T pos[2], pmean[2], eyp[2], myp[2][2];
  typename Arith<T>::A eypA[2], mypA[2][2];
  if constexpr (kIhgp) {
    const T *pwy = wt.pwy, *pmy = wt.pmy;
    pmean[0] = w[L - 1].x;
    pmean[1] = w[L - 1].y;
#pragma unroll 8
    for (int l = 0; l < L; ++l) {
      const V4<T> cur = w[l];
      const T yv[2] = {fp::sub(cur.x, pmean[0]), fp::sub(cur.y, pmean[1])};
#pragma unroll
      for (int ax = 0; ax < 2; ++ax) {
        const auto e = Arith<T>::mul(yv[ax], pwy[ax * L + l]);
        const auto c0 = Arith<T>::mul(yv[ax], pmy[(ax * 2 + 0) * L + l]);
        const auto c1 = Arith<T>::mul(yv[ax], pmy[(ax * 2 + 1) * L + l]);
        eypA[ax] = l ? Arith<T>::add(eypA[ax], e) : e;
        mypA[ax][0] = l ? Arith<T>::add(mypA[ax][0], c0) : c0;
        mypA[ax][1] = l ? Arith<T>::add(mypA[ax][1], c1) : c1;
      }
    }
    for (int ax = 0; ax < 2; ++ax) {
      eyp[ax] = Arith<T>::fin(eypA[ax]);
      myp[ax][0] = Arith<T>::fin(mypA[ax][0]);
      myp[ax][1] = Arith<T>::fin(mypA[ax][1]);
    }
  } else {
    pos[0] = Arith<T>::lpf(a.lpf_a, w[L - 2].x, a.lpf_b, w[L - 1].x);
    pos[1] = Arith<T>::lpf(a.lpf_a, w[L - 2].y, a.lpf_b, w[L - 1].y);
  }
  // chained passes, run as detections ask for them: detection d reads pass
  // ordinal[d] = (updates of slot k at or before d) - 1
  T vel[2] = {T(0), T(0)};
  int done = 0, cnt = 0;
  for (int d = 0; d < D; ++d) {
    if (r.slot[d] != k) continue;
    cnt += act[d];
    if (cnt == 0) continue;
    while (done < cnt) {
      T mn[2][2];
      if constexpr (kIhgp) {  // the position pass; the velocity pass chains on its carry
        const T *pwm = wt.pwm, *pmm = wt.pmm;
        for (int ax = 0; ax < 2; ++ax) {
          const T em = Arith<T>::dot2(m[ax][0], pwm[2 * ax], m[ax][1], pwm[2 * ax + 1]);
          pos[ax] = fp::add(fp::add(eyp[ax], em), pmean[ax]);
          for (int tt = 0; tt < 2; ++tt) {
            mn[ax][tt] = fp::add(myp[ax][tt], Arith<T>::dot2(m[ax][0], pmm[(ax * 2 + tt) * 2],
                                                             m[ax][1], pmm[(ax * 2 + tt) * 2 + 1]));
          }
        }
        for (int q = 0; q < 4; ++q) m[q >> 1][q & 1] = mn[q >> 1][q & 1];
      }
      for (int ax = 0; ax < 2; ++ax) {
        const T em = Arith<T>::dot2(m[ax][0], wm[2 * ax], m[ax][1], wm[2 * ax + 1]);
        T v = fp::add(fp::add(ey[ax], em), vmean[ax]);
        // clamp, NaN-preserving like the C++ if-chain (cpp:649-654)
        v = v > a.vmax ? a.vmax : (v < -a.vmax ? -a.vmax : v);
        vel[ax] = v;
        for (int tt = 0; tt < 2; ++tt) {
          mn[ax][tt] = fp::add(myv[ax][tt], Arith<T>::dot2(m[ax][0], mm[(ax * 2 + tt) * 2],
                                                           m[ax][1], mm[(ax * 2 + tt) * 2 + 1]));
        }
      }
      for (int q = 0; q < 4; ++q) m[q >> 1][q & 1] = mn[q >> 1][q & 1];
      ++done;
    }
    a.pos[2 * (fs * D + d)] = pos[0];
    a.pos[2 * (fs * D + d) + 1] = pos[1];
    a.vel[2 * (fs * D + d)] = vel[0];
    a.vel[2 * (fs * D + d) + 1] = vel[1];
  }
}

// A frame's pos / vel defaults: det * 0 (NaN-preserving), for detections no
// pass reads.
template <class T>
__device__ __forceinline__ void pos_vel_defaults(const TrackArgs<T>& a, const T* dets, size_t fs,
                                                 int d) {
  const T zx = fp::mul(dets[4 * d], T(0)), zy = fp::mul(dets[4 * d + 1], T(0));
  a.pos[2 * (fs * a.D + d)] = zx;
  a.pos[2 * (fs * a.D + d) + 1] = zy;
  a.vel[2 * (fs * a.D + d)] = zx;
  a.vel[2 * (fs * a.D + d) + 1] = zy;
}

template <class T, int kLanes, bool kIhgp, bool kAuction>
__global__ void __launch_bounds__(kLanes) track_step_kernel(TrackArgs<T> a) {
  // W_vel: wy_last (2, L-1), wm_last (2, 2), my (2, 2, L-1), mm (2, 2, 2);
  // then under ihgp W_pos: wy_last (2, L), wm_last (2, 2), my (2, 2, L), mm (2, 2, 2)
  extern __shared__ __align__(16) unsigned char s_wraw[];
  T* s_w = reinterpret_cast<T*>(s_wraw);
  __shared__ T s_det[kMaxDets * 4];
  __shared__ int s_dv[kMaxDets];
  __shared__ int s_act[kMaxDets];
  __shared__ Decisions s_res;
  __shared__ ScanScratch<T, kLanes> s_sc;
  const int b = blockIdx.x;
  const int k = threadIdx.x;
  const int S = a.S, K = a.K, D = a.D, L = a.L, L1 = L - 1;
  const bool in_k = k < K;

  T* wy = s_w;
  T* wm = wy + 2 * L1;
  T* my = wm + 4;
  T* mm = my + 4 * L1;
  for (int i = k; i < 2 * L1; i += blockDim.x) {
    const int ax = i / L1, l = i % L1;
    wy[i] = a.wy[((size_t)ax * L1 + (L1 - 1)) * L1 + l];
  }
  for (int i = k; i < 4; i += blockDim.x) wm[i] = a.wm[((i >> 1) * L1 + (L1 - 1)) * 2 + (i & 1)];
  for (int i = k; i < 4 * L1; i += blockDim.x) my[i] = a.my[i];
  for (int i = k; i < 8; i += blockDim.x) mm[i] = a.mm[i];
  T* pwy = mm + 8;
  T* pwm = pwy + 2 * L;
  T* pmy = pwm + 4;
  T* pmm = pmy + 4 * L;
  if constexpr (kIhgp) {
    for (int i = k; i < 2 * L; i += blockDim.x) {
      const int ax = i / L, l = i % L;
      pwy[i] = a.pwy[((size_t)ax * L + (L - 1)) * L + l];
    }
    for (int i = k; i < 4; i += blockDim.x)
      pwm[i] = a.pwm[((i >> 1) * L + (L - 1)) * 2 + (i & 1)];
    for (int i = k; i < 4 * L; i += blockDim.x) pmy[i] = a.pmy[i];
    for (int i = k; i < 8; i += blockDim.x) pmm[i] = a.pmm[i];
  }

  // this lane's slot: summary and carry in registers, window row in place
  // in the output buffer
  Lane<T> me = {T(0), T(0), T(0), 0, 0, 0};
  T m[2][2] = {{T(0), T(0)}, {T(0), T(0)}};
  V4<T>* w = reinterpret_cast<V4<T>*>(a.win_out) + ((size_t)b * K + (in_k ? k : 0)) * L;
  if (in_k) {
    const V4<T>* __restrict__ w_in =
        reinterpret_cast<const V4<T>*>(a.win_in) + ((size_t)b * K + k) * L;
    V4<T>* __restrict__ w_out = w;
#pragma unroll 8
    for (int l = 0; l < L; ++l) w_out[l] = w_in[l];
    me.lx = w[L - 1].x;
    me.ly = w[L - 1].y;
    me.lt = w[L - 1].w;
    const size_t bk = (size_t)b * K + k;
    me.alive = a.alive_in[bk] != 0;
    me.oid = a.oid_in[bk];
    me.birth = a.birth_in[bk];
    for (int q = 0; q < 4; ++q) m[q >> 1][q & 1] = a.m0_in[4 * bk + q];
  }
  int nobj = a.nobj_in[b], nbirth = a.nbirth_in[b], spin = a.spin_in[b];
  bool init = a.init_in[b] != 0;

  for (int s = 0; s < S; ++s) {
    const size_t fs = (size_t)b * S + s;
    const T* dets = a.dets + fs * D * 4;
    for (int d = k; d < D; d += blockDim.x) {
      for (int q = 0; q < 4; ++q) s_det[4 * d + q] = dets[4 * d + q];
      s_dv[d] = a.dv[fs * D + d] != 0;
      // pos / vel default: det * 0 (NaN-preserving), for detections no pass reads
      const T zx = fp::mul(dets[4 * d], T(0)), zy = fp::mul(dets[4 * d + 1], T(0));
      a.pos[2 * (fs * D + d)] = zx;
      a.pos[2 * (fs * D + d) + 1] = zy;
      a.vel[2 * (fs * D + d)] = zx;
      a.vel[2 * (fs * D + d) + 1] = zy;
    }
    decision_defaults(s_res, D);
    __syncthreads();
    const int bound = last_valid_bound(s_dv, D);
    const bool any_det = bound > 0;
    const bool steady = init && any_det;
    int ovf = 0, sat = 0;
    if constexpr (kAuction && sizeof(T) == sizeof(double)) {
      unsigned char* dyn = s_wraw + weights_smem<T>(L, kIhgp);
      auto& s_h = *reinterpret_cast<HungarianScratch<T, kLanes>*>(dyn);
      auto& s_wide = *reinterpret_cast<WideScratch<T, kLanes>*>(
          dyn + ((sizeof(HungarianScratch<T, kLanes>) + 15) & ~(size_t)15));
      hungarian_decide<T, kLanes>(s_det, s_dv, init, a.thr, a.gapthr, a.dt, K, D, a.au, me,
                                  nobj, nbirth, ovf, sat, s_sc.red[0][0], s_h, s_wide, s_res);
    } else if constexpr (kAuction) {
      __shared__ HungarianScratch<T, kLanes> s_h;
      __shared__ WideScratch<T, kLanes> s_wide;
      hungarian_decide<T, kLanes>(s_det, s_dv, init, a.thr, a.gapthr, a.dt, K, D, a.au, me,
                                  nobj, nbirth, ovf, sat, s_sc.red[0][0], s_h, s_wide, s_res);
    } else {
      decide<T, kLanes>(s_det, s_dv, bound, init, a.thr, a.gapthr, a.dt, K, me, nobj, nbirth,
                        ovf, s_sc, s_res);
    }
    for (int d = k; d < D; d += blockDim.x) s_act[d] = (s_res.ok[d] && steady) ? 1 : 0;
    __syncthreads();

    if (in_k) {
      update_window(w, L, s_det, s_res, D, k, a.dt);
      // a registration zeroes the slot's GP carry (the ctor, cpp:45)
      for (int d = 0; d < D; ++d) {
        if (s_res.is_new[d] && s_res.slot[d] == k) {
          m[0][0] = m[0][1] = m[1][0] = m[1][1] = T(0);
        }
      }
      int mult = 0;
      for (int d = 0; d < D; ++d) mult += (s_act[d] && s_res.slot[d] == k) ? 1 : 0;
      if (mult > 0) {
        // velocity window, its mean, the y-parts of the smoother sums and
        // the LPF position: once per frame, ascending in the window index
        // (each row read once per pass, both axes together; unrolled so
        // the row loads overlap)
        T vmean[2], ey[2], myv[2][2];
        typename Arith<T>::A sum[2], eyA[2], myvA[2][2];
        XY<T> prev = {w[0].x, w[0].y};
#pragma unroll 8
        for (int l = 0; l < L1; ++l) {
          const V4<T> cur = w[l + 1];
          const auto vx = Arith<T>::vel_term(fp::sub(cur.x, prev.x), a.dt);
          const auto vy = Arith<T>::vel_term(fp::sub(cur.y, prev.y), a.dt);
          sum[0] = l ? Arith<T>::add(sum[0], vx) : vx;
          sum[1] = l ? Arith<T>::add(sum[1], vy) : vy;
          prev = XY<T>{cur.x, cur.y};
        }
        vmean[0] = Arith<T>::mean(sum[0], L1);
        vmean[1] = Arith<T>::mean(sum[1], L1);
        prev = XY<T>{w[0].x, w[0].y};
#pragma unroll 8
        for (int l = 0; l < L1; ++l) {
          const V4<T> cur = w[l + 1];
          const T yv[2] = {
              Arith<T>::centred(fp::sub(cur.x, prev.x), a.dt, vmean[0]),
              Arith<T>::centred(fp::sub(cur.y, prev.y), a.dt, vmean[1])};
          prev = XY<T>{cur.x, cur.y};
#pragma unroll
          for (int ax = 0; ax < 2; ++ax) {
            const auto e = Arith<T>::mul(yv[ax], wy[ax * L1 + l]);
            const auto c0 = Arith<T>::mul(yv[ax], my[(ax * 2 + 0) * L1 + l]);
            const auto c1 = Arith<T>::mul(yv[ax], my[(ax * 2 + 1) * L1 + l]);
            eyA[ax] = l ? Arith<T>::add(eyA[ax], e) : e;
            myvA[ax][0] = l ? Arith<T>::add(myvA[ax][0], c0) : c0;
            myvA[ax][1] = l ? Arith<T>::add(myvA[ax][1], c1) : c1;
          }
        }
        for (int ax = 0; ax < 2; ++ax) {
          ey[ax] = Arith<T>::fin(eyA[ax]);
          myv[ax][0] = Arith<T>::fin(myvA[ax][0]);
          myv[ax][1] = Arith<T>::fin(myvA[ax][1]);
        }
        // the position: LPF once per frame, or under ihgp the y-parts of
        // the position smoother (pmean = the last row's xy, y_l = row l's
        // xy less pmean), ascending in l, and a position pass per pass
        T pos[2], pmean[2], eyp[2], myp[2][2];
        typename Arith<T>::A eypA[2], mypA[2][2];
        if constexpr (kIhgp) {
          pmean[0] = w[L - 1].x;
          pmean[1] = w[L - 1].y;
#pragma unroll 8
          for (int l = 0; l < L; ++l) {
            const V4<T> cur = w[l];
            const T yv[2] = {fp::sub(cur.x, pmean[0]), fp::sub(cur.y, pmean[1])};
#pragma unroll
            for (int ax = 0; ax < 2; ++ax) {
              const auto e = Arith<T>::mul(yv[ax], pwy[ax * L + l]);
              const auto c0 = Arith<T>::mul(yv[ax], pmy[(ax * 2 + 0) * L + l]);
              const auto c1 = Arith<T>::mul(yv[ax], pmy[(ax * 2 + 1) * L + l]);
              eypA[ax] = l ? Arith<T>::add(eypA[ax], e) : e;
              mypA[ax][0] = l ? Arith<T>::add(mypA[ax][0], c0) : c0;
              mypA[ax][1] = l ? Arith<T>::add(mypA[ax][1], c1) : c1;
            }
          }
          for (int ax = 0; ax < 2; ++ax) {
            eyp[ax] = Arith<T>::fin(eypA[ax]);
            myp[ax][0] = Arith<T>::fin(mypA[ax][0]);
            myp[ax][1] = Arith<T>::fin(mypA[ax][1]);
          }
        } else {
          pos[0] = Arith<T>::lpf(a.lpf_a, w[L - 2].x, a.lpf_b, w[L - 1].x);
          pos[1] = Arith<T>::lpf(a.lpf_a, w[L - 2].y, a.lpf_b, w[L - 1].y);
        }
        // chained passes, run as detections ask for them: detection d
        // reads pass ordinal[d] = (updates of slot k at or before d) - 1
        T vel[2] = {T(0), T(0)};
        int done = 0, cnt = 0;
        for (int d = 0; d < D; ++d) {
          if (s_res.slot[d] != k) continue;
          cnt += s_act[d];
          if (cnt == 0) continue;
          while (done < cnt) {
            T mn[2][2];
            if constexpr (kIhgp) {  // the position pass; the velocity pass chains on its carry
              for (int ax = 0; ax < 2; ++ax) {
                const T em = Arith<T>::dot2(m[ax][0], pwm[2 * ax], m[ax][1], pwm[2 * ax + 1]);
                pos[ax] = fp::add(fp::add(eyp[ax], em), pmean[ax]);
                for (int tt = 0; tt < 2; ++tt) {
                  mn[ax][tt] = fp::add(
                      myp[ax][tt], Arith<T>::dot2(m[ax][0], pmm[(ax * 2 + tt) * 2], m[ax][1],
                                                  pmm[(ax * 2 + tt) * 2 + 1]));
                }
              }
              for (int q = 0; q < 4; ++q) m[q >> 1][q & 1] = mn[q >> 1][q & 1];
            }
            for (int ax = 0; ax < 2; ++ax) {
              const T em = Arith<T>::dot2(m[ax][0], wm[2 * ax], m[ax][1], wm[2 * ax + 1]);
              T v = fp::add(fp::add(ey[ax], em), vmean[ax]);
              // clamp, NaN-preserving like the C++ if-chain (cpp:649-654)
              v = v > a.vmax ? a.vmax : (v < -a.vmax ? -a.vmax : v);
              vel[ax] = v;
              for (int tt = 0; tt < 2; ++tt) {
                mn[ax][tt] = fp::add(
                    myv[ax][tt], Arith<T>::dot2(m[ax][0], mm[(ax * 2 + tt) * 2], m[ax][1],
                                                mm[(ax * 2 + tt) * 2 + 1]));
              }
            }
            for (int q = 0; q < 4; ++q) m[q >> 1][q & 1] = mn[q >> 1][q & 1];
            ++done;
          }
          a.pos[2 * (fs * D + d)] = pos[0];
          a.pos[2 * (fs * D + d) + 1] = pos[1];
          a.vel[2 * (fs * D + d)] = vel[0];
          a.vel[2 * (fs * D + d) + 1] = vel[1];
        }
      }
    }

    // expiry (cpp:545-584)
    spin += steady ? 1 : 0;
    const bool prune = spin > a.prune_spin && steady;
    if (in_k && prune) {
      const bool stale = fp::sub(a.t[fs], w[L - 1].w) > a.prune_period;
      if (stale) me.alive = 0;
    }
    if (prune) spin = 0;
    const int n_alive = __syncthreads_count(in_k && me.alive);
    for (int d = k; d < D; d += blockDim.x) {
      a.valid[fs * D + d] = (s_res.ok[d] && steady) ? 1 : 0;
      a.obj_id[fs * D + d] = s_res.id[d];
      a.new_track[fs * D + d] = s_res.is_new[d] ? 1 : 0;
    }
    if (k == 0) {
      a.publish[fs] = steady ? 1 : 0;
      a.counts[4 * fs] = n_alive;
      a.counts[4 * fs + 1] = ovf;
      a.counts[4 * fs + 2] = 0;  // dup_saturated: every multiplicity runs exactly
      a.counts[4 * fs + 3] = sat;  // assoc_saturated: the auction's; greedy never saturates
    }
    init = init || any_det;
    __syncthreads();  // s_det, s_dv, s_res are rewritten by the next frame
  }

  if (in_k) {
    const size_t bk = (size_t)b * K + k;
    a.alive_out[bk] = me.alive ? 1 : 0;
    a.oid_out[bk] = me.oid;
    a.birth_out[bk] = me.birth;
    for (int q = 0; q < 4; ++q) a.m0_out[4 * bk + q] = m[q >> 1][q & 1];
  }
  if (k == 0) {
    a.nobj_out[b] = nobj;
    a.nbirth_out[b] = nbirth;
    a.spin_out[b] = spin;
    a.init_out[b] = init ? 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// K4 xl: the track step past one CTA's lanes (K > 1,024 slots) or the shared
// detection buffer (D > 128)
// ---------------------------------------------------------------------------
// One CTA of up to 1,024 threads per bank, as K4, but lane t owns slots t,
// t + blockDim.x, t + 2 blockDim.x, ...: each slot's summary (last x / y /
// t, alive, id, birth_seq) sits in device memory indexed by slot, its GP
// carry in m0_out, its window row in win_out (as K4), and the frame's
// detection flags and decisions in device memory too (the detections are
// read where they lie).  Every block-wide reduction first reduces a lane's
// own slots in ascending slot order, then runs K4's warp and block
// reduction, so every decision is K4's; every sum is the same ascending
// loop (slot_step).  Under hungarian the auction's tables are sized for n =
// D + K columns at run time (AuctionTables), in dynamic shared memory after
// the weights while they fit, else in the bank's device-memory scratch; the
// cost is rebuilt as in K4, never stored.  The scratch is the wrapper's
// (xl_layout bytes per bank); nothing in it needs zeroing.

constexpr size_t kSmemBytes = 232448;  // what one H100 block may use (227 KB)
constexpr size_t kXlStaticSmem = 2048;  // the xl kernel's static shared arrays, rounded up

// Byte offsets of K4 xl's per-bank scratch.  Per slot: lx, ly, lt (T), alive,
// oid, birth (int).  Per detection: the five decisions, the active flags,
// the valid flags (int).  Under hungarian the tables follow, from `tables`
// (in the scratch, or at the start of the shared memory after the weights
// when tables_smem): each slot's last x / y, the free slots by rank, the
// registered detections by rank, three counters, and the auction's.
struct XlLayout {
  size_t lx, ly, lt, alive, oid, birth;
  size_t dslot, did, dnew, dok, dinterp, dact, ddv;
  size_t tables;  // the tables' offset in the scratch (unused when tables_smem)
  size_t last, free_slot, reg_det, misc, price, owner, row_col, key, bid_col, bid_row, feas_n,
      feas_col, feas_val, bid_val, krow;  // from the tables' base
  size_t table_bytes;
  size_t bank;  // the scratch's bytes per bank
  int tables_smem;
};

__host__ __device__ inline size_t xl_take(size_t& off, size_t bytes) {
  const size_t o = off;
  off += (bytes + 15) & ~(size_t)15;
  return o;
}

__host__ __device__ inline XlLayout xl_layout(int K, int D, size_t tsize, bool auction,
                                              size_t smem_free) {
  XlLayout y{};
  size_t off = 0;
  y.lx = xl_take(off, K * tsize);
  y.ly = xl_take(off, K * tsize);
  y.lt = xl_take(off, K * tsize);
  y.alive = xl_take(off, K * sizeof(int));
  y.oid = xl_take(off, K * sizeof(int));
  y.birth = xl_take(off, K * sizeof(int));
  y.dslot = xl_take(off, D * sizeof(int));
  y.did = xl_take(off, D * sizeof(int));
  y.dnew = xl_take(off, D * sizeof(int));
  y.dok = xl_take(off, D * sizeof(int));
  y.dinterp = xl_take(off, D * sizeof(int));
  y.dact = xl_take(off, D * sizeof(int));
  y.ddv = xl_take(off, D * sizeof(int));
  if (auction) {
    const size_t n = (size_t)D + K;
    size_t t = 0;
    y.last = xl_take(t, K * 2 * tsize);
    y.free_slot = xl_take(t, K * sizeof(int));
    y.reg_det = xl_take(t, D * sizeof(int));
    y.misc = xl_take(t, 4 * sizeof(int));
    y.price = xl_take(t, n * tsize);
    y.owner = xl_take(t, n * sizeof(int));
    y.row_col = xl_take(t, n * sizeof(int));
    y.key = xl_take(t, n * sizeof(unsigned long long));
    y.bid_col = xl_take(t, (D + 1) * sizeof(int));
    y.bid_row = xl_take(t, (D + 1) * sizeof(int));
    y.feas_n = xl_take(t, D * sizeof(int));
    y.feas_col = xl_take(t, (size_t)D * motl_auction::kMaxFeas * sizeof(int));
    y.feas_val = xl_take(t, (size_t)D * motl_auction::kMaxFeas * tsize);
    y.bid_val = xl_take(t, tsize == sizeof(double) ? (D + 1) * sizeof(double) : 0);
    y.krow = xl_take(t, tsize == sizeof(double) ? n * sizeof(int) : 0);
    y.table_bytes = t;
    y.tables_smem = t <= smem_free ? 1 : 0;
    y.tables = y.tables_smem ? 0 : xl_take(off, t);
  }
  y.bank = off;
  return y;
}

// A slot's summary in device memory, indexed by slot.
template <class T>
struct SlotsXl {
  T *lx, *ly, *lt;
  int *alive, *oid, *birth;
};

// The Hungarian tables of one bank.
template <class T>
struct HungarianXl {
  motl_auction::AuctionTables<T> auc;
  motl_auction::WideTables wide;
  XY<T>* last;
  int* free_slot;
  int* reg_det;
  int* misc;  // [0] saturated phases, [1] detections that want a slot
};

template <class T>
__device__ HungarianXl<T> hungarian_tables(unsigned char* base, const XlLayout& y) {
  using Row = int[motl_auction::kMaxFeas];
  using RowT = T[motl_auction::kMaxFeas];
  HungarianXl<T> h;
  h.auc = {reinterpret_cast<T*>(base + y.price), reinterpret_cast<int*>(base + y.owner),
           reinterpret_cast<int*>(base + y.row_col),
           reinterpret_cast<unsigned long long*>(base + y.key),
           reinterpret_cast<int*>(base + y.bid_col), reinterpret_cast<int*>(base + y.bid_row),
           reinterpret_cast<int*>(base + y.feas_n), reinterpret_cast<Row*>(base + y.feas_col),
           reinterpret_cast<RowT*>(base + y.feas_val)};
  h.wide = {reinterpret_cast<double*>(base + y.bid_val), reinterpret_cast<int*>(base + y.krow)};
  h.last = reinterpret_cast<XY<T>*>(base + y.last);
  h.free_slot = reinterpret_cast<int*>(base + y.free_slot);
  h.reg_det = reinterpret_cast<int*>(base + y.reg_det);
  h.misc = reinterpret_cast<int*>(base + y.misc);
  return h;
}

// K4's block reduction of the four scan values, after each lane reduced its
// own slots: warp shuffles, then the warps' values through sc.red[buf].
template <class T>
__device__ __forceinline__ void scan_reduce(int& any, int& bmin, int& fmin, int& full,
                                            ScanScratch<T, kMaxLanes>& sc, int buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    any |= __shfl_xor_sync(0xffffffffu, any, o);
    bmin = min(bmin, __shfl_xor_sync(0xffffffffu, bmin, o));
    fmin = min(fmin, __shfl_xor_sync(0xffffffffu, fmin, o));
    full &= __shfl_xor_sync(0xffffffffu, full, o);
  }
  if (lane == 0) {
    sc.red[buf][0][warp] = any;
    sc.red[buf][1][warp] = bmin;
    sc.red[buf][2][warp] = fmin;
    sc.red[buf][3][warp] = full;
  }
  __syncthreads();
  any = 0, bmin = kBig, fmin = kBig, full = 1;
  for (int w = 0; w < n_warps; ++w) {
    any |= sc.red[buf][0][w];
    bmin = min(bmin, sc.red[buf][1][w]);
    fmin = min(fmin, sc.red[buf][2][w]);
    full &= sc.red[buf][3][w];
  }
}

// decide over a lane's several slots: the same decisions, one detection at
// a time.  The selected slot's summary is written by the lane that owns it.
template <class T>
__device__ void decide_xl(const T* det, const int* dv, int bound, bool allow, T thr, T gapthr,
                          T dt, int K, const SlotsXl<T>& st, int& nobj, int& nbirth, int& ovf,
                          ScanScratch<T, kMaxLanes>& sc, const DecisionsXl& r) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int j = 0; j < bound; ++j) {
    const T d0 = det[4 * j], d1 = det[4 * j + 1], d3 = det[4 * j + 3];
    const bool valid = dv[j] != 0;
    // this lane's slots, ascending: its gated slot of least birth_seq, its
    // lowest free slot, whether all its slots are alive
    int my_any = 0, my_bmin = kBig, my_b = -1, my_fmin = kBig, my_full = 1;
    for (int k = tid; k < K; k += nt) {
      const bool is_alive = st.alive[k] > 0;
      const T dx = fp::sub(d0, st.lx[k]), dy = fp::sub(d1, st.ly[k]);
      const T dist = fp::sqrt(fp::add(fp::mul(dx, dx), fp::mul(dy, dy)));
      const bool gate = is_alive && dist < thr && allow;
      if (gate) {
        my_any = 1;
        if (st.birth[k] < my_bmin) {
          my_bmin = st.birth[k];
          my_b = k;
        }
      }
      if (!is_alive && my_fmin == kBig) my_fmin = k;
      my_full &= is_alive ? 1 : 0;
    }
    const int buf = j & 1;
    if (tid == 0) {  // defaults for "no slot selected" (full bank, no match)
      sc.sel[buf].slot = 0;
      sc.sel[buf].t = T(0);
      sc.sel[buf].id = 0;
    }
    int any = my_any, bmin = my_bmin, fmin = my_fmin, full = my_full;
    scan_reduce(any, bmin, fmin, full, sc, buf);
    const bool am = any != 0;
    const bool bank_full = full != 0;
    // the selected slot is unique: min birth_seq among gated, else the
    // first free slot
    const int sel = am ? (my_b >= 0 && my_bmin == bmin ? my_b : -1)
                       : (fmin < kBig && my_fmin == fmin ? fmin : -1);
    if (sel >= 0) {
      sc.sel[buf].slot = sel;
      sc.sel[buf].t = st.lt[sel];
      sc.sel[buf].id = st.oid[sel];
    }
    __syncthreads();
    const int sel_slot = sc.sel[buf].slot;
    const T t_slot = sc.sel[buf].t;
    const int id_slot = sc.sel[buf].id;
    const T gap = fp::sub(d3, t_slot);
    const bool do_interp =
        am && gap > gapthr && fp::sub(fp::rint(Arith<T>::div_dt(gap, dt)), T(1)) >= T(1);
    const bool reg = valid && !am && !bank_full;
    const bool matched = valid && am;
    const bool write = matched || reg;
    if (sel >= 0 && write) {
      st.lx[sel] = d0;
      st.ly[sel] = d1;
      st.lt[sel] = d3;
    }
    if (sel >= 0 && reg) {
      st.alive[sel] = 1;
      st.oid[sel] = nobj;
      st.birth[sel] = nbirth;
    }
    if (tid == 0) {
      r.slot[j] = sel_slot;
      r.id[j] = matched ? id_slot : (reg ? nobj : -1);
      r.is_new[j] = reg ? 1 : 0;
      r.ok[j] = write ? 1 : 0;
      r.interp[j] = (do_interp && write) ? 1 : 0;
    }
    nobj += reg ? 1 : 0;
    nbirth += reg ? 1 : 0;
    ovf += (valid && !am && bank_full) ? 1 : 0;
  }
  __syncthreads();
}

// hungarian_decide over a lane's several slots: the auction on tables sized
// for n = D + K, the matches by each slot's owner, the free slots ranked in
// slot order one round of blockDim.x slots at a time, the registrations by
// rank.  Ends with a barrier; nobj, nbirth, ovf and sat come out the same in
// every thread.
template <class T>
__device__ void hungarian_decide_xl(const T* det, const int* dv, bool allow, T thr, T gapthr,
                                    T dt, int K, int D, const motl_auction::AuctionParams<T>& au,
                                    const SlotsXl<T>& st, int& nobj, int& nbirth, int& ovf,
                                    int& sat, int* s_wcount, HungarianXl<T>& h,
                                    const DecisionsXl& r) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n_warps = nt >> 5;
  const unsigned below = (1u << lane) - 1u;
  for (int k = tid; k < K; k += nt) {
    const T nan = T(NAN);
    h.last[k] = st.alive[k] ? XY<T>{st.lx[k], st.ly[k]} : XY<T>{nan, nan};
  }
  __syncthreads();
  const TrackValue<T> value{det, dv, h.last, allow, thr, au.neg};
  motl_auction::auction_lists(value, D, K, au.neg, h.auc, warp, n_warps);
  __syncthreads();
  if (warp == 0) {
    motl_auction::WideTables* wk = nullptr;
    if constexpr (sizeof(T) == sizeof(double)) wk = &h.wide;
    const int s = motl_auction::auction_warp(value, D, K, au, h.auc, wk, nullptr);
    if (lane == 0) h.misc[0] = s;
  }
  __syncthreads();
  sat = h.misc[0];
  // a match: the detection owning real column k, with the pre-frame slot's
  // id and last t (the interpolation test)
  for (int k = tid; k < K; k += nt) {
    const int own = h.auc.owner[k];
    if (own >= 0 && own < D) {
      const T t_det = det[4 * own + 3];
      const T gap = fp::sub(t_det, st.lt[k]);
      r.slot[own] = k;
      r.id[own] = st.oid[k];
      r.ok[own] = 1;
      r.interp[own] =
          (gap > gapthr && fp::sub(fp::rint(Arith<T>::div_dt(gap, dt)), T(1)) >= T(1)) ? 1 : 0;
      st.lx[k] = det[4 * own];
      st.ly[k] = det[4 * own + 1];
      st.lt[k] = t_det;
    }
  }
  // the free slots' ranks (slot order), one round of nt slots at a time
  int n_free = 0;
  for (int k0 = 0; k0 < K; k0 += nt) {
    const int k = k0 + tid;
    const bool free_k = k < K && !st.alive[k];
    const unsigned fb = __ballot_sync(kFull, free_k);
    if (lane == 0) s_wcount[warp] = __popc(fb);
    __syncthreads();
    int rank = n_free + __popc(fb & below), tot = 0;
    for (int w = 0; w < n_warps; ++w) {
      const int c = s_wcount[w];
      rank += w < warp ? c : 0;
      tot += c;
    }
    if (free_k) h.free_slot[rank] = k;
    n_free += tot;
    __syncthreads();  // s_wcount is rewritten by the next round
  }
  // registrations: the unmatched valid detections, in order, take the free
  // slots by rank
  if (warp == 0) {
    int cnt = 0;
    for (int base = 0; base < D; base += 32) {
      const int d = base + lane;
      const int col = d < D ? h.auc.row_col[d] : -1;
      const bool want = d < D && dv[d] && !(col >= 0 && col < K);
      const unsigned wb = __ballot_sync(kFull, want);
      const int q = cnt + __popc(wb & below);
      if (want && q < n_free) {
        r.slot[d] = h.free_slot[q];
        r.id[d] = nobj + q;
        r.is_new[d] = 1;
        r.ok[d] = 1;
        h.reg_det[q] = d;
      }
      cnt += __popc(wb);
    }
    if (lane == 0) h.misc[1] = cnt;
  }
  __syncthreads();
  const int n_want = h.misc[1], n_reg = min(n_want, n_free);
  for (int q = tid; q < n_reg; q += nt) {
    const int k = h.free_slot[q], d = h.reg_det[q];
    st.alive[k] = 1;
    st.oid[k] = nobj + q;
    st.birth[k] = nbirth + q;
    st.lx[k] = det[4 * d];
    st.ly[k] = det[4 * d + 1];
    st.lt[k] = det[4 * d + 3];
  }
  nobj += n_reg;
  nbirth += n_reg;
  ovf += n_want - n_reg;
  __syncthreads();
}

// The block's sum of one int per thread (s_red: a word per warp).
__device__ __forceinline__ int block_sum(int v, int* s_red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = __reduce_add_sync(kFull, v);
  if (lane == 0) s_red[warp] = v;
  __syncthreads();
  int tot = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) tot += s_red[w];
  return tot;
}

template <class T, bool kIhgp, bool kAuction>
__global__ void __launch_bounds__(kMaxLanes)
track_step_xl_kernel(TrackArgs<T> a, unsigned char* scratch, XlLayout y) {
  extern __shared__ __align__(16) unsigned char s_wraw[];
  __shared__ ScanScratch<T, kMaxLanes> s_sc;
  __shared__ int s_red[kMaxLanes / 32];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int S = a.S, K = a.K, D = a.D, L = a.L;
  const Weights<T> wt = load_weights<T, kIhgp>(a, reinterpret_cast<T*>(s_wraw));
  unsigned char* base = scratch + (size_t)b * y.bank;
  const SlotsXl<T> st{reinterpret_cast<T*>(base + y.lx), reinterpret_cast<T*>(base + y.ly),
                      reinterpret_cast<T*>(base + y.lt), reinterpret_cast<int*>(base + y.alive),
                      reinterpret_cast<int*>(base + y.oid),
                      reinterpret_cast<int*>(base + y.birth)};
  const DecisionsXl r{reinterpret_cast<int*>(base + y.dslot), reinterpret_cast<int*>(base + y.did),
                      reinterpret_cast<int*>(base + y.dnew), reinterpret_cast<int*>(base + y.dok),
                      reinterpret_cast<int*>(base + y.dinterp)};
  int* act = reinterpret_cast<int*>(base + y.dact);
  int* dv = reinterpret_cast<int*>(base + y.ddv);
  V4<T>* win = reinterpret_cast<V4<T>*>(a.win_out) + (size_t)b * K * L;

  for (int k = tid; k < K; k += nt) {
    const size_t bk = (size_t)b * K + k;
    const V4<T>* __restrict__ w_in = reinterpret_cast<const V4<T>*>(a.win_in) + bk * L;
    V4<T>* w = win + (size_t)k * L;
    for (int l = 0; l < L; ++l) w[l] = w_in[l];
    st.lx[k] = w[L - 1].x;
    st.ly[k] = w[L - 1].y;
    st.lt[k] = w[L - 1].w;
    st.alive[k] = a.alive_in[bk] != 0;
    st.oid[k] = a.oid_in[bk];
    st.birth[k] = a.birth_in[bk];
    for (int q = 0; q < 4; ++q) a.m0_out[4 * bk + q] = a.m0_in[4 * bk + q];
  }
  int nobj = a.nobj_in[b], nbirth = a.nbirth_in[b], spin = a.spin_in[b];
  bool init = a.init_in[b] != 0;

  for (int s = 0; s < S; ++s) {
    const size_t fs = (size_t)b * S + s;
    const T* dets = a.dets + fs * D * 4;
    for (int d = tid; d < D; d += nt) {
      dv[d] = a.dv[fs * D + d] != 0;
      pos_vel_defaults(a, dets, fs, d);
    }
    decision_defaults(r, D);
    __syncthreads();
    const int bound = last_valid_bound(dv, D);
    const bool any_det = bound > 0;
    const bool steady = init && any_det;
    int ovf = 0, sat = 0;
    if constexpr (kAuction) {
      HungarianXl<T> h = hungarian_tables<T>(
          y.tables_smem ? s_wraw + weights_smem<T>(L, kIhgp) : base + y.tables, y);
      hungarian_decide_xl<T>(dets, dv, init, a.thr, a.gapthr, a.dt, K, D, a.au, st, nobj,
                             nbirth, ovf, sat, s_red, h, r);
    } else {
      decide_xl<T>(dets, dv, bound, init, a.thr, a.gapthr, a.dt, K, st, nobj, nbirth, ovf, s_sc,
                   r);
    }
    for (int d = tid; d < D; d += nt) act[d] = (r.ok[d] && steady) ? 1 : 0;
    __syncthreads();

    for (int k = tid; k < K; k += nt) {
      const size_t bk = (size_t)b * K + k;
      T m[2][2];
      for (int q = 0; q < 4; ++q) m[q >> 1][q & 1] = a.m0_out[4 * bk + q];
      slot_step<T, kIhgp>(a, wt, win + (size_t)k * L, m, k, dets, r, act, fs);
      for (int q = 0; q < 4; ++q) a.m0_out[4 * bk + q] = m[q >> 1][q & 1];
    }

    // expiry (cpp:545-584)
    spin += steady ? 1 : 0;
    const bool prune = spin > a.prune_spin && steady;
    int alive_cnt = 0;
    for (int k = tid; k < K; k += nt) {
      if (prune && fp::sub(a.t[fs], win[(size_t)k * L + L - 1].w) > a.prune_period)
        st.alive[k] = 0;
      alive_cnt += st.alive[k] ? 1 : 0;
    }
    if (prune) spin = 0;
    const int n_alive = block_sum(alive_cnt, s_red);
    for (int d = tid; d < D; d += nt) {
      a.valid[fs * D + d] = (r.ok[d] && steady) ? 1 : 0;
      a.obj_id[fs * D + d] = r.id[d];
      a.new_track[fs * D + d] = r.is_new[d] ? 1 : 0;
    }
    if (tid == 0) {
      a.publish[fs] = steady ? 1 : 0;
      a.counts[4 * fs] = n_alive;
      a.counts[4 * fs + 1] = ovf;
      a.counts[4 * fs + 2] = 0;
      a.counts[4 * fs + 3] = sat;
    }
    init = init || any_det;
    __syncthreads();  // the decisions, flags and s_red are rewritten by the next frame
  }

  for (int k = tid; k < K; k += nt) {
    const size_t bk = (size_t)b * K + k;
    a.alive_out[bk] = st.alive[k] ? 1 : 0;
    a.oid_out[bk] = st.oid[k];
    a.birth_out[bk] = st.birth[k];
  }
  if (tid == 0) {
    a.nobj_out[b] = nobj;
    a.nbirth_out[b] = nbirth;
    a.spin_out[b] = spin;
    a.init_out[b] = init ? 1 : 0;
  }
}

}  // namespace

// The f32 and double entries below build with this file; the half entries
// (motl_track_step{,_xl}_{bf16,f16}) with assign_half.cu, which includes it
// with MOTL_ASSIGN_HALF defined, so that nvcc compiles the two at once.
#ifndef MOTL_ASSIGN_HALF
// af0 (K, 3) f32 [last_x, last_y, last_t]; ai0 (K, 3) i32 [alive, obj_id,
// birth_seq]; dets (D, 4) f32; dv (D,) u8; allow (1,) i32; cnt_in (2,) i32
// [next_obj_num, next_birth].  Outputs: ai_out (K, 3) i32, outs (5, D) i32
// [slot, id, new, ok, interp], cnt_out (3,) i32 [next_obj_num, next_birth,
// overflow].  1 <= K <= 1024, D <= 128.
extern "C" int motl_assoc_scan(const float* af0, const int* ai0, const float* dets,
                               const uint8_t* dv, const int* allow, const int* cnt_in,
                               int K, int D, float thr, float gapthr, float dt,
                               int* ai_out, int* outs, int* cnt_out, void* stream) {
  if (K < 1 || K > kMaxLanes || D > kMaxDets) return (int)cudaErrorInvalidValue;
  const int threads = (K + 31) / 32 * 32;
  const cudaStream_t st = (cudaStream_t)stream;
  if (threads <= kNarrowLanes)
    assoc_scan_kernel<kNarrowLanes><<<1, threads, 0, st>>>(
        af0, ai0, dets, dv, allow, cnt_in, K, D, thr, gapthr, dt, ai_out, outs, cnt_out);
  else
    assoc_scan_kernel<kMaxLanes><<<1, threads, 0, st>>>(
        af0, ai0, dets, dv, allow, cnt_in, K, D, thr, gapthr, dt, ai_out, outs, cnt_out);
  return (int)cudaGetLastError();
}
#endif  // MOTL_ASSIGN_HALF

template <class T, int kLanes, bool kIhgp, bool kAuction>
cudaError_t launch_track(const TrackArgs<T>& a, int B, int threads, size_t smem,
                         cudaStream_t st) {
  smem += hungarian_smem<T, kLanes, kAuction>();
  if (kAuction) {  // the auction's static tables fill most of the 48 KB without opt-in
    const cudaError_t e = cudaFuncSetAttribute(track_step_kernel<T, kLanes, kIhgp, kAuction>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return e;
  }
  track_step_kernel<T, kLanes, kIhgp, kAuction><<<B, threads, smem, st>>>(a);
  return cudaGetLastError();
}

template <class T, int kLanes>
cudaError_t launch_track_width(const TrackArgs<T>& a, bool ihgp, bool auction, int B,
                               int threads, size_t smem, cudaStream_t st) {
  if (auction)
    return ihgp ? launch_track<T, kLanes, true, true>(a, B, threads, smem, st)
                : launch_track<T, kLanes, false, true>(a, B, threads, smem, st);
  return ihgp ? launch_track<T, kLanes, true, false>(a, B, threads, smem, st)
              : launch_track<T, kLanes, false, false>(a, B, threads, smem, st);
}

// The auction's parameters from the entry's host array: of T for the f32
// and double builds, of floats holding half values for the half builds.
template <class T>
bool auction_params(const void* f, int n_phases, int max_iters, motl_auction::AuctionParams<T>* p) {
  return motl_auction::read_params(static_cast<const T*>(f), n_phases, max_iters, p);
}
template <class H>
bool auction_params(const void* f, int n_phases, int max_iters,
                    motl_auction::AuctionParams<HV<H>>* p) {
  return motl_auction::read_params_half<H>(static_cast<const float*>(f), n_phases, max_iters, p);
}

template <class T>
int track_step(TrackArgs<T>& a, const void* auction_f, int ihgp, int auction, int n_phases,
               int max_iters, int B) {
  const int K = a.K, D = a.D, L = a.L;
  if (B < 1 || a.S < 1 || K < 1 || K > kMaxLanes || D < 1 || D > kMaxDets || L < 2)
    return (int)cudaErrorInvalidValue;
  if (auction && !auction_params(auction_f, n_phases, max_iters, &a.au))
    return (int)cudaErrorInvalidValue;
  const int threads = (K + 31) / 32 * 32;
  const size_t smem = weights_smem<T>(L, ihgp);
  const cudaStream_t st = (cudaStream_t)a.stream;
  if (threads <= kNarrowLanes)
    return (int)launch_track_width<T, kNarrowLanes>(a, ihgp, auction, B, threads, smem, st);
  return (int)launch_track_width<T, kMaxLanes>(a, ihgp, auction, B, threads, smem, st);
}

// K4 xl's layout for a bank of K slots and D detections: the weights'
// shared memory first, the Hungarian tables after them while they fit.
template <class T>
XlLayout xl_layout_for(int K, int D, int L, bool ihgp, bool auction) {
  const size_t smem = weights_smem<T>(L, ihgp);
  const size_t room = kSmemBytes - kXlStaticSmem - smem;
  return xl_layout(K, D, sizeof(T), auction, room);
}

template <class T, bool kIhgp, bool kAuction>
cudaError_t launch_track_xl(const TrackArgs<T>& a, int B, unsigned char* scratch,
                            const XlLayout& y, cudaStream_t st) {
  const int threads = a.K >= kMaxLanes ? kMaxLanes : (a.K + 31) / 32 * 32;
  const size_t smem = weights_smem<T>(a.L, kIhgp) + (y.tables_smem ? y.table_bytes : 0);
  const cudaError_t e = cudaFuncSetAttribute(track_step_xl_kernel<T, kIhgp, kAuction>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
  if (e != cudaSuccess) return e;
  track_step_xl_kernel<T, kIhgp, kAuction><<<B, threads, smem, st>>>(a, scratch, y);
  return cudaGetLastError();
}

template <class T>
int track_step_xl(TrackArgs<T>& a, const void* auction_f, int ihgp, int auction, int n_phases,
                  int max_iters, int B, void* scratch) {
  if (B < 1 || a.S < 1 || a.K < 1 || a.D < 1 || a.L < 2 || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  if (auction && !auction_params(auction_f, n_phases, max_iters, &a.au))
    return (int)cudaErrorInvalidValue;
  const XlLayout y = xl_layout_for<T>(a.K, a.D, a.L, ihgp, auction);
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  const cudaStream_t st = (cudaStream_t)a.stream;
  if (auction)
    return (int)(ihgp ? launch_track_xl<T, true, true>(a, B, sc, y, st)
                      : launch_track_xl<T, false, true>(a, B, sc, y, st));
  return (int)(ihgp ? launch_track_xl<T, true, false>(a, B, sc, y, st)
                    : launch_track_xl<T, false, false>(a, B, sc, y, st));
}

#ifndef MOTL_ASSIGN_HALF
// The whole track step of B banks over S frames each, one CTA per bank.
// Inputs: dets (B, S, D, 4) f32, dv (B, S, D) u8, t (B, S) f32; the state
// alive (B, K) u8, obj_id (B, K) i32, birth_seq (B, K) i32, window (B, K,
// L, 4) f32, m0 (B, K, 2, 2) f32, next_obj_num / next_birth / spin (B,)
// i32, initialized (B,) u8; W_vel's Wy (2, L-1, L-1), Wm (2, L-1, 2), My
// (2, 2, L-1), Mm (2, 2, 2) f32; W_pos's Wy (2, L, L), Wm (2, L, 2), My
// (2, 2, L), Mm (2, 2, 2) f32, read only when ihgp != 0 (the position
// filter is "ihgp").  auction != 0 selects Hungarian association, whose
// parameters are read from auction_f, a HOST array [neg, neg_half,
// neg_pen, neg_pen2, eps_0, ..., eps_{n_phases - 1}] (f32,
// ops/hungarian.py::auction_schedule), with n_phases and max_iters;
// auction_f is not read under greedy association.  Outputs: the state
// after the S frames in the same layouts, and per frame publish (B, S) u8,
// valid / new_track (B, S, D) u8, obj_id (B, S, D) i32, pos / vel (B, S,
// D, 2) f32, counts (B, S, 4) i32 [n_alive, overflow, dup_saturated,
// assoc_saturated].  1 <= K <= 1024, 1 <= D <= 128, L >= 2.
extern "C" int motl_track_step(
    const float* dets, const uint8_t* dv, const float* t, const uint8_t* alive_in,
    const int* oid_in, const int* birth_in, const float* win_in, const float* m0_in,
    const int* nobj_in, const int* nbirth_in, const int* spin_in, const uint8_t* init_in,
    const float* wy, const float* wm, const float* my, const float* mm, const float* pwy,
    const float* pwm, const float* pmy, const float* pmm, int ihgp, int auction,
    const float* auction_f, int n_phases, int max_iters, int B, int S, int K,
    int D, int L, float thr, float gapthr, float dt, float vmax, float lpf_a, float lpf_b,
    float prune_period, int prune_spin, uint8_t* alive_out, int* oid_out, int* birth_out,
    float* win_out, float* m0_out, int* nobj_out, int* nbirth_out, int* spin_out,
    uint8_t* init_out, uint8_t* publish, uint8_t* valid, int* obj_id, float* pos, float* vel,
    uint8_t* new_track, int* counts, void* stream) {
  TrackArgs<float> a{dets, dv, t, alive_in, oid_in, birth_in, win_in, m0_in, nobj_in,
                     nbirth_in, spin_in, init_in, wy, wm, my, mm, pwy, pwm, pmy, pmm, S, K, D,
                     L, thr, gapthr, dt, vmax, lpf_a, lpf_b, prune_period, prune_spin,
                     alive_out, oid_out, birth_out, win_out, m0_out, nobj_out, nbirth_out,
                     spin_out, init_out, publish, valid, obj_id, pos, vel, new_track, counts,
                     {}, stream};
  return track_step(a, auction_f, ihgp, auction, n_phases, max_iters, B);
}

// The double builds: every float array and scalar of motl_track_step in f64
// (dets, t, window, m0, the smoother weights, pos / vel, auction_f and the
// seven scalars); the rest as motl_track_step.
extern "C" int motl_track_step_f64(
    const double* dets, const uint8_t* dv, const double* t, const uint8_t* alive_in,
    const int* oid_in, const int* birth_in, const double* win_in, const double* m0_in,
    const int* nobj_in, const int* nbirth_in, const int* spin_in, const uint8_t* init_in,
    const double* wy, const double* wm, const double* my, const double* mm, const double* pwy,
    const double* pwm, const double* pmy, const double* pmm, int ihgp, int auction,
    const double* auction_f, int n_phases, int max_iters, int B, int S, int K,
    int D, int L, double thr, double gapthr, double dt, double vmax, double lpf_a,
    double lpf_b, double prune_period, int prune_spin, uint8_t* alive_out, int* oid_out,
    int* birth_out, double* win_out, double* m0_out, int* nobj_out, int* nbirth_out,
    int* spin_out, uint8_t* init_out, uint8_t* publish, uint8_t* valid, int* obj_id,
    double* pos, double* vel, uint8_t* new_track, int* counts, void* stream) {
  TrackArgs<double> a{dets, dv, t, alive_in, oid_in, birth_in, win_in, m0_in, nobj_in,
                      nbirth_in, spin_in, init_in, wy, wm, my, mm, pwy, pwm, pmy, pmm, S, K, D,
                      L, thr, gapthr, dt, vmax, lpf_a, lpf_b, prune_period, prune_spin,
                      alive_out, oid_out, birth_out, win_out, m0_out, nobj_out, nbirth_out,
                      spin_out, init_out, publish, valid, obj_id, pos, vel, new_track, counts,
                      {}, stream};
  return track_step(a, auction_f, ihgp, auction, n_phases, max_iters, B);
}

// K4 xl: the whole track step at any K >= 1 and D >= 1 (past K4's 1,024
// slots or 128 detections), the arguments of motl_track_step and
// motl_track_step_f64 and, before the stream, the bank scratch: B times
// motl_track_step_xl_scratch's bytes of device memory (nothing in it needs
// zeroing).
extern "C" int motl_track_step_xl(
    const float* dets, const uint8_t* dv, const float* t, const uint8_t* alive_in,
    const int* oid_in, const int* birth_in, const float* win_in, const float* m0_in,
    const int* nobj_in, const int* nbirth_in, const int* spin_in, const uint8_t* init_in,
    const float* wy, const float* wm, const float* my, const float* mm, const float* pwy,
    const float* pwm, const float* pmy, const float* pmm, int ihgp, int auction,
    const float* auction_f, int n_phases, int max_iters, int B, int S, int K,
    int D, int L, float thr, float gapthr, float dt, float vmax, float lpf_a, float lpf_b,
    float prune_period, int prune_spin, uint8_t* alive_out, int* oid_out, int* birth_out,
    float* win_out, float* m0_out, int* nobj_out, int* nbirth_out, int* spin_out,
    uint8_t* init_out, uint8_t* publish, uint8_t* valid, int* obj_id, float* pos, float* vel,
    uint8_t* new_track, int* counts, void* scratch, void* stream) {
  TrackArgs<float> a{dets, dv, t, alive_in, oid_in, birth_in, win_in, m0_in, nobj_in,
                     nbirth_in, spin_in, init_in, wy, wm, my, mm, pwy, pwm, pmy, pmm, S, K, D,
                     L, thr, gapthr, dt, vmax, lpf_a, lpf_b, prune_period, prune_spin,
                     alive_out, oid_out, birth_out, win_out, m0_out, nobj_out, nbirth_out,
                     spin_out, init_out, publish, valid, obj_id, pos, vel, new_track, counts,
                     {}, stream};
  return track_step_xl(a, auction_f, ihgp, auction, n_phases, max_iters, B, scratch);
}

extern "C" int motl_track_step_xl_f64(
    const double* dets, const uint8_t* dv, const double* t, const uint8_t* alive_in,
    const int* oid_in, const int* birth_in, const double* win_in, const double* m0_in,
    const int* nobj_in, const int* nbirth_in, const int* spin_in, const uint8_t* init_in,
    const double* wy, const double* wm, const double* my, const double* mm, const double* pwy,
    const double* pwm, const double* pmy, const double* pmm, int ihgp, int auction,
    const double* auction_f, int n_phases, int max_iters, int B, int S, int K,
    int D, int L, double thr, double gapthr, double dt, double vmax, double lpf_a,
    double lpf_b, double prune_period, int prune_spin, uint8_t* alive_out, int* oid_out,
    int* birth_out, double* win_out, double* m0_out, int* nobj_out, int* nbirth_out,
    int* spin_out, uint8_t* init_out, uint8_t* publish, uint8_t* valid, int* obj_id,
    double* pos, double* vel, uint8_t* new_track, int* counts, void* scratch, void* stream) {
  TrackArgs<double> a{dets, dv, t, alive_in, oid_in, birth_in, win_in, m0_in, nobj_in,
                      nbirth_in, spin_in, init_in, wy, wm, my, mm, pwy, pwm, pmy, pmm, S, K, D,
                      L, thr, gapthr, dt, vmax, lpf_a, lpf_b, prune_period, prune_spin,
                      alive_out, oid_out, birth_out, win_out, m0_out, nobj_out, nbirth_out,
                      spin_out, init_out, publish, valid, obj_id, pos, vel, new_track, counts,
                      {}, stream};
  return track_step_xl(a, auction_f, ihgp, auction, n_phases, max_iters, B, scratch);
}

#endif  // MOTL_ASSIGN_HALF

#ifdef MOTL_ASSIGN_HALF
// The half builds (motl_track_step_bf16 / _f16, K4 xl's motl_track_step_xl_
// bf16 / _f16; greedy and Hungarian association): the arguments of
// motl_track_step, every float array a bf16 / f16 tensor of the build's
// type, read and written as such, the seven scalars and auction_f's
// parameters half values as floats (in f16 the auction's neg and neg_half
// are -inf); the arithmetic K4's body spells on HV<H> (fp_half.cuh, which
// holds a value's bits) and Arith<HV<H>>, the auction's on HV<H> too
// (auction_half.cuh).
template <class H, class St = typename H::storage>
TrackArgs<HV<H>> half_args(
    const St* dets, const uint8_t* dv, const St* t, const uint8_t* alive_in, const int* oid_in,
    const int* birth_in, const St* win_in, const St* m0_in, const int* nobj_in,
    const int* nbirth_in, const int* spin_in, const uint8_t* init_in, const St* wy,
    const St* wm, const St* my, const St* mm, const St* pwy, const St* pwm, const St* pmy,
    const St* pmm, int S, int K, int D, int L,
    float thr, float gapthr, float dt, float vmax, float lpf_a, float lpf_b,
    float prune_period, int prune_spin, uint8_t* alive_out, int* oid_out, int* birth_out,
    St* win_out, St* m0_out, int* nobj_out, int* nbirth_out, int* spin_out,
    uint8_t* init_out, uint8_t* publish, uint8_t* valid, int* obj_id, St* pos, St* vel,
    uint8_t* new_track, int* counts, void* stream) {
  using V = HV<H>;
  auto c = [](const St* p) { return reinterpret_cast<const V*>(p); };
  auto m = [](St* p) { return reinterpret_cast<V*>(p); };
  return TrackArgs<V>{c(dets), dv, c(t), alive_in, oid_in, birth_in, c(win_in), c(m0_in),
                      nobj_in, nbirth_in, spin_in, init_in, c(wy), c(wm), c(my), c(mm), c(pwy),
                      c(pwm), c(pmy), c(pmm), S, K, D, L, V::raw(thr), V::raw(gapthr),
                      V::raw(dt), V::raw(vmax), V::raw(lpf_a), V::raw(lpf_b),
                      V::raw(prune_period), prune_spin, alive_out, oid_out, birth_out,
                      m(win_out), m(m0_out), nobj_out, nbirth_out, spin_out, init_out,
                      publish, valid, obj_id, m(pos), m(vel), new_track, counts, {}, stream};
}

using bf16_t = __nv_bfloat16;
using f16_t = __half;

extern "C" int motl_track_step_bf16(
    const bf16_t* dets, const uint8_t* dv, const bf16_t* t, const uint8_t* alive_in,
    const int* oid_in, const int* birth_in, const bf16_t* win_in, const bf16_t* m0_in,
    const int* nobj_in, const int* nbirth_in, const int* spin_in, const uint8_t* init_in,
    const bf16_t* wy, const bf16_t* wm, const bf16_t* my, const bf16_t* mm, const bf16_t* pwy,
    const bf16_t* pwm, const bf16_t* pmy, const bf16_t* pmm, int ihgp, int auction,
    const float* auction_f, int n_phases, int max_iters, int B, int S, int K, int D, int L,
    float thr, float gapthr, float dt, float vmax, float lpf_a, float lpf_b, float prune_period,
    int prune_spin, uint8_t* alive_out, int* oid_out, int* birth_out, bf16_t* win_out,
    bf16_t* m0_out, int* nobj_out, int* nbirth_out, int* spin_out, uint8_t* init_out,
    uint8_t* publish, uint8_t* valid, int* obj_id, bf16_t* pos, bf16_t* vel, uint8_t* new_track,
    int* counts, void* stream) {
  auto a = half_args<fp::BF16>(
      dets, dv, t, alive_in, oid_in, birth_in, win_in, m0_in, nobj_in, nbirth_in, spin_in,
      init_in, wy, wm, my, mm, pwy, pwm, pmy, pmm, S, K, D, L, thr, gapthr, dt, vmax, lpf_a,
      lpf_b, prune_period, prune_spin, alive_out, oid_out, birth_out, win_out, m0_out,
      nobj_out, nbirth_out, spin_out, init_out, publish, valid, obj_id, pos, vel, new_track,
      counts, stream);
  return track_step(a, auction_f, ihgp, auction, n_phases, max_iters, B);
}

extern "C" int motl_track_step_f16(
    const f16_t* dets, const uint8_t* dv, const f16_t* t, const uint8_t* alive_in,
    const int* oid_in, const int* birth_in, const f16_t* win_in, const f16_t* m0_in,
    const int* nobj_in, const int* nbirth_in, const int* spin_in, const uint8_t* init_in,
    const f16_t* wy, const f16_t* wm, const f16_t* my, const f16_t* mm, const f16_t* pwy,
    const f16_t* pwm, const f16_t* pmy, const f16_t* pmm, int ihgp, int auction,
    const float* auction_f, int n_phases, int max_iters, int B, int S, int K, int D, int L,
    float thr, float gapthr, float dt, float vmax, float lpf_a, float lpf_b, float prune_period,
    int prune_spin, uint8_t* alive_out, int* oid_out, int* birth_out, f16_t* win_out,
    f16_t* m0_out, int* nobj_out, int* nbirth_out, int* spin_out, uint8_t* init_out,
    uint8_t* publish, uint8_t* valid, int* obj_id, f16_t* pos, f16_t* vel, uint8_t* new_track,
    int* counts, void* stream) {
  auto a = half_args<fp::F16>(
      dets, dv, t, alive_in, oid_in, birth_in, win_in, m0_in, nobj_in, nbirth_in, spin_in,
      init_in, wy, wm, my, mm, pwy, pwm, pmy, pmm, S, K, D, L, thr, gapthr, dt, vmax, lpf_a,
      lpf_b, prune_period, prune_spin, alive_out, oid_out, birth_out, win_out, m0_out,
      nobj_out, nbirth_out, spin_out, init_out, publish, valid, obj_id, pos, vel, new_track,
      counts, stream);
  return track_step(a, auction_f, ihgp, auction, n_phases, max_iters, B);
}

extern "C" int motl_track_step_xl_bf16(
    const bf16_t* dets, const uint8_t* dv, const bf16_t* t, const uint8_t* alive_in,
    const int* oid_in, const int* birth_in, const bf16_t* win_in, const bf16_t* m0_in,
    const int* nobj_in, const int* nbirth_in, const int* spin_in, const uint8_t* init_in,
    const bf16_t* wy, const bf16_t* wm, const bf16_t* my, const bf16_t* mm, const bf16_t* pwy,
    const bf16_t* pwm, const bf16_t* pmy, const bf16_t* pmm, int ihgp, int auction,
    const float* auction_f, int n_phases, int max_iters, int B, int S, int K, int D, int L,
    float thr, float gapthr, float dt, float vmax, float lpf_a, float lpf_b, float prune_period,
    int prune_spin, uint8_t* alive_out, int* oid_out, int* birth_out, bf16_t* win_out,
    bf16_t* m0_out, int* nobj_out, int* nbirth_out, int* spin_out, uint8_t* init_out,
    uint8_t* publish, uint8_t* valid, int* obj_id, bf16_t* pos, bf16_t* vel, uint8_t* new_track,
    int* counts, void* scratch, void* stream) {
  auto a = half_args<fp::BF16>(
      dets, dv, t, alive_in, oid_in, birth_in, win_in, m0_in, nobj_in, nbirth_in, spin_in,
      init_in, wy, wm, my, mm, pwy, pwm, pmy, pmm, S, K, D, L, thr, gapthr, dt, vmax, lpf_a,
      lpf_b, prune_period, prune_spin, alive_out, oid_out, birth_out, win_out, m0_out,
      nobj_out, nbirth_out, spin_out, init_out, publish, valid, obj_id, pos, vel, new_track,
      counts, stream);
  return track_step_xl(a, auction_f, ihgp, auction, n_phases, max_iters, B,
                       scratch);
}

extern "C" int motl_track_step_xl_f16(
    const f16_t* dets, const uint8_t* dv, const f16_t* t, const uint8_t* alive_in,
    const int* oid_in, const int* birth_in, const f16_t* win_in, const f16_t* m0_in,
    const int* nobj_in, const int* nbirth_in, const int* spin_in, const uint8_t* init_in,
    const f16_t* wy, const f16_t* wm, const f16_t* my, const f16_t* mm, const f16_t* pwy,
    const f16_t* pwm, const f16_t* pmy, const f16_t* pmm, int ihgp, int auction,
    const float* auction_f, int n_phases, int max_iters, int B, int S, int K, int D, int L,
    float thr, float gapthr, float dt, float vmax, float lpf_a, float lpf_b, float prune_period,
    int prune_spin, uint8_t* alive_out, int* oid_out, int* birth_out, f16_t* win_out,
    f16_t* m0_out, int* nobj_out, int* nbirth_out, int* spin_out, uint8_t* init_out,
    uint8_t* publish, uint8_t* valid, int* obj_id, f16_t* pos, f16_t* vel, uint8_t* new_track,
    int* counts, void* scratch, void* stream) {
  auto a = half_args<fp::F16>(
      dets, dv, t, alive_in, oid_in, birth_in, win_in, m0_in, nobj_in, nbirth_in, spin_in,
      init_in, wy, wm, my, mm, pwy, pwm, pmy, pmm, S, K, D, L, thr, gapthr, dt, vmax, lpf_a,
      lpf_b, prune_period, prune_spin, alive_out, oid_out, birth_out, win_out, m0_out,
      nobj_out, nbirth_out, spin_out, init_out, publish, valid, obj_id, pos, vel, new_track,
      counts, stream);
  return track_step_xl(a, auction_f, ihgp, auction, n_phases, max_iters, B,
                       scratch);
}

#endif  // MOTL_ASSIGN_HALF

#ifndef MOTL_ASSIGN_HALF
// K4 xl's scratch bytes per bank (out[0]) and whether the Hungarian tables
// sit in shared memory (out[1]) for K slots, D detections, window length
// L, f64 != 0 for the double builds.
extern "C" int motl_track_step_xl_scratch(int K, int D, int L, int f64, int ihgp, int auction,
                                          long long* out) {
  if (K < 1 || D < 1 || L < 2 || out == nullptr) return (int)cudaErrorInvalidValue;
  const XlLayout y = f64 ? xl_layout_for<double>(K, D, L, ihgp, auction)
                         : xl_layout_for<float>(K, D, L, ihgp, auction);
  out[0] = (long long)y.bank;
  out[1] = y.tables_smem;
  return 0;
}
#endif  // MOTL_ASSIGN_HALF
