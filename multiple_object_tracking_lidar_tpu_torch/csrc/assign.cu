// K4: the order-faithful greedy association scan.
//
// Replaces the Pallas kernel multiple_object_tracking_lidar_tpu/ops/
// assign_pallas.py::assoc_scan_pallas (body _kernel).  Detections are
// visited in order up to the last valid one + 1; each gates the alive
// tracks with sqrt(dx^2 + dy^2) < thr, claims the gated track with the
// smallest birth_seq (registration order), or registers in the lowest free
// slot, or counts an overflow when the bank is full; it writes the slot's
// last x / y / t, and flags the interpolation backfill when the gap exceeds
// factor * dt.  Per detection: slot, id, new, ok, interp; per track: alive,
// obj_id, birth_seq; plus next_obj_num, next_birth and the overflow count.
// det_slot is defined only where det_ok (assign_pallas.py:159-169).
//
// What bounds it on the H100: latency -- the scan is sequential over at
// most D <= 128 detections, a few dozen instructions each.  Design: one CTA
// of 32 * ceil(K / 32) threads, one lane per track slot; the bank summary
// lives in registers, the detections in shared memory.  Each detection
// needs four block-wide reductions ("any gated", "smallest birth_seq among
// gated", "lowest free slot", "bank full"), done with warp shuffles plus
// one shared-memory exchange across the CTA's warps.  What bounds K: one
// lane per slot in one CTA, so K <= 1,024 (the largest CTA); a bank grown
// past that raises in the wrapper.  D <= 128 is the shared detection
// buffer.  The kernel is built twice, for CTAs of up to 128 and of up to
// 1,024 threads: a 1,024-thread bound caps ptxas at 64 registers per
// thread, where this kernel spills, so banks of K <= 128 (the default
// K = 64 among them) launch the 128-thread build and keep its registers.  The distance uses __fmul_rn / __fadd_rn and IEEE sqrtf; the
// interp rounding uses rintf (round half to even, as jnp.round).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDets = 128;
constexpr int kMaxLanes = 1024;
constexpr int kNarrowLanes = 128;  // the TPU kernel's K bound
constexpr int kBig = 1 << 30;

struct Selected {
  int slot;
  float t;
  int id;
};

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
  __shared__ int s_red[2][4][kLanes / 32];
  __shared__ Selected s_sel[2];
  const int k = threadIdx.x;
  const int lane = k & 31, warp = k >> 5;
  const int n_warps = blockDim.x >> 5;
  const bool in_k = k < K;

  float lx = 0.f, ly = 0.f, lt = 0.f;
  int alive = 0, oid = 0, birth = 0;
  if (in_k) {
    lx = af0[3 * k];
    ly = af0[3 * k + 1];
    lt = af0[3 * k + 2];
    alive = ai0[3 * k];
    oid = ai0[3 * k + 1];
    birth = ai0[3 * k + 2];
  }
  for (int d = k; d < D; d += blockDim.x) {
    for (int q = 0; q < 4; ++q) s_det[4 * d + q] = dets[4 * d + q];
    s_dv[d] = dv[d] != 0;
  }
  // outputs default: slot 0, id -1, new 0, ok 0, interp 0
  for (int d = k; d < D; d += blockDim.x) {
    outs[d] = 0;
    outs[D + d] = -1;
    outs[2 * D + d] = 0;
    outs[3 * D + d] = 0;
    outs[4 * D + d] = 0;
  }
  const bool allow = allow_p[0] != 0;
  int nobj = cnt_in[0], nbirth = cnt_in[1], ovf = 0;
  __syncthreads();
  int bound = 0;
  for (int d = 0; d < D; ++d)
    if (s_dv[d]) bound = d + 1;

  for (int j = 0; j < bound; ++j) {
    const float d0 = s_det[4 * j], d1 = s_det[4 * j + 1], d3 = s_det[4 * j + 3];
    const bool valid = s_dv[j] != 0;
    const bool is_alive = in_k && alive > 0;
    const float dx = __fsub_rn(d0, lx), dy = __fsub_rn(d1, ly);
    const float dist = sqrtf(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
    const bool gate = is_alive && dist < thr && allow;
    const bool is_free = in_k && !is_alive;
    int r_any = gate ? 1 : 0;
    int r_bmin = gate ? birth : kBig;
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
      s_sel[buf].slot = 0;
      s_sel[buf].t = 0.0f;
      s_sel[buf].id = 0;
    }
    if (lane == 0) {
      s_red[buf][0][warp] = r_any;
      s_red[buf][1][warp] = r_bmin;
      s_red[buf][2][warp] = r_fmin;
      s_red[buf][3][warp] = r_full;
    }
    __syncthreads();
    int any = 0, bmin = kBig, fmin = kBig, full = 1;
    for (int w = 0; w < n_warps; ++w) {
      any |= s_red[buf][0][w];
      bmin = min(bmin, s_red[buf][1][w]);
      fmin = min(fmin, s_red[buf][2][w]);
      full &= s_red[buf][3][w];
    }
    const bool am = any != 0;
    const bool bank_full = full != 0;
    // the selected lane is unique: min birth_seq among gated (births are
    // unique among alive tracks), else the first free slot
    const bool sel = am ? (gate && birth == bmin) : (is_free && k == fmin);
    if (sel) {
      s_sel[buf].slot = k;
      s_sel[buf].t = lt;
      s_sel[buf].id = oid;
    }
    __syncthreads();
    const int sel_slot = s_sel[buf].slot;
    const float t_slot = s_sel[buf].t;
    const int id_slot = s_sel[buf].id;
    const float gap = __fsub_rn(d3, t_slot);
    const bool do_interp =
        am && gap > gapthr && __fsub_rn(rintf(gap / dt), 1.0f) >= 1.0f;
    const bool reg = valid && !am && !bank_full;
    const bool matched = valid && am;
    const bool write = matched || reg;
    if (sel && write) {
      lx = d0;
      ly = d1;
      lt = d3;
    }
    if (sel && reg) {
      alive = 1;
      oid = nobj;
      birth = nbirth;
    }
    if (k == 0) {
      outs[j] = sel_slot;
      outs[D + j] = matched ? id_slot : (reg ? nobj : -1);
      outs[2 * D + j] = reg ? 1 : 0;
      outs[3 * D + j] = write ? 1 : 0;
      outs[4 * D + j] = (do_interp && write) ? 1 : 0;
    }
    nobj += reg ? 1 : 0;
    nbirth += reg ? 1 : 0;
    ovf += (valid && !am && bank_full) ? 1 : 0;
  }
  if (in_k) {
    ai_out[3 * k] = alive;
    ai_out[3 * k + 1] = oid;
    ai_out[3 * k + 2] = birth;
  }
  if (k == 0) {
    cnt_out[0] = nobj;
    cnt_out[1] = nbirth;
    cnt_out[2] = ovf;
  }
}

}  // namespace

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
