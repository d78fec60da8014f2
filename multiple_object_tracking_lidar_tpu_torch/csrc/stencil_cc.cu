// K14: the dense grid's stencil connected components (grid_cc="jnp", a map
// with no per-cell static table -- the vmap fleet --, a grid past K2's
// cells), one CTA per frame, one launch per call.
//
// Replaces no TPU kernel: the JAX package runs multiple_object_tracking_
// lidar_tpu/ops/cluster_grid.py::connected_components_grid (:60) as jnp
// inside its jitted step, one while_loop (its fused Pallas CC stops at
// 32,768 cells, grid_pallas.py:44-54).  Before this kernel the port ran it
// in plain torch with one host sync per iteration and (O, n) neighbour
// tables (0.9 GB at 744,200 cells and 146 offsets).  Semantics, kept bit
// for bit (ops/cluster_grid.py::connected_components_grid_plain):
//   - labels are int32, the min flat cell index of each component, n for
//     cells that are not dynamic;
//   - neighbour j = i + (dx, dy, dz) of cell i is adjacent when both are
//     dynamic and fma(dz, dz, fma(dx, dx, dy * dy)) <= tol^2 in the
//     centroids' type (d = c_i - c_j; __fmaf_rn / __fma_rn, as XLA's CPU
//     code contracts sum((c - c_j) ** 2)); a neighbour outside the grid is
//     never dynamic;
//   - an iteration is `sweeps` Jacobi sweeps (each reads the labels the
//     previous one wrote: new_i = min(lab_i, min over adjacent j of lab_j))
//     then `jumps` pointer jumps (lab_i = lab[lab_i]); `changed` compares
//     the iteration's result with its start; a frame stops at no change or
//     after max_iters iterations; n_sweeps = iterations * sweeps and
//     saturated = changed && iterations >= max_iters.
//
// What bounds it on the H100: latency.  A frame holds a few thousand
// dynamic cells of hundreds of thousands (744,200 on a 30 m floor at 0.05
// m), and each pass is a barrier-separated step over them; the bytes (the
// (S, n) labels written once, the dynamic flags read once) take
// microseconds.  Design, per frame, one CTA of 1,024 threads:
//   1. the frame's dynamic cells listed in ascending order (each thread
//      counts a contiguous segment of the flags, one block-wide scan, then
//      each writes its segment's entries), and every cell's label written
//      (n, or its own index where dynamic) into the output;
//   2. each listed cell's adjacency packed into ceil(O / 32) bit words
//      once (146 offsets: 5 words), its neighbours' flags and centroids
//      read from the grid on the fly;
//   3. the iterations over the list: Jacobi passes between the output and
//      a scratch buffer of the same size (both read only at dynamic cells),
//      a block barrier between passes, the frame's "changed" flag in shared
//      memory -- labels only fall, so "changed since the iteration's start"
//      is "some pass lowered a label" -- and the CTA stops on its own.  No
//      host sync; frames never wait for each other.
// The scratch (list, second label buffer, adjacency words: (2 + W) int32
// per cell and frame) is the wrapper's; nothing in it needs zeroing.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fp_rn.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxOffsets = 256;

// The block's exclusive prefix of one int per thread, and its total.
__device__ __forceinline__ int block_exclusive_scan(int v, int* s_warp, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  int before = 0;
  total = 0;
  for (int w = 0; w < n_warps; ++w) {
    const int c = s_warp[w];
    before += w < warp ? c : 0;
    total += c;
  }
  return before + x - v;
}

template <class T>
__global__ void __launch_bounds__(kThreads)
stencil_cc_kernel(const T* __restrict__ cent, const uint8_t* __restrict__ dyn, int gx, int gy,
                  int gz, const int* __restrict__ offsets, int n_off, T tol2, int max_iters,
                  int sweeps, int jumps, int* labels, int* __restrict__ nsw, int* scratch) {
  __shared__ int s_dx[kMaxOffsets], s_dy[kMaxOffsets], s_dz[kMaxOffsets], s_delta[kMaxOffsets];
  __shared__ int s_warp[kThreads / 32];
  __shared__ int s_changed;
  const int f = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int n = gx * gy * gz;
  const int W = (n_off + 31) / 32;
  const T* cx = cent + (size_t)f * 3 * n;
  const T* cy = cx + n;
  const T* cz = cy + n;
  const uint8_t* dv = dyn + (size_t)f * n;
  int* lab_a = labels + (size_t)f * n;
  int* base = scratch + (size_t)f * n * (2 + W);
  int* list = base;
  int* lab_b = base + n;
  uint32_t* adj = reinterpret_cast<uint32_t*>(base + 2 * (size_t)n);
  for (int o = tid; o < n_off; o += nt) {
    s_dz[o] = offsets[3 * o];
    s_dy[o] = offsets[3 * o + 1];
    s_dx[o] = offsets[3 * o + 2];
    s_delta[o] = s_dx[o] + gx * (s_dy[o] + gy * s_dz[o]);
  }

  // 1. the dynamic cells, listed in ascending order; every label
  const int seg = (n + nt - 1) / nt;
  const int lo = min(n, tid * seg), hi = min(n, lo + seg);
  int cnt = 0;
  for (int i = lo; i < hi; ++i) cnt += dv[i] != 0;
  int nd = 0;
  int at = block_exclusive_scan(cnt, s_warp, nd);
  for (int i = lo; i < hi; ++i)
    if (dv[i]) list[at++] = i;
  for (int i = tid; i < n; i += nt) lab_a[i] = dv[i] ? i : n;
  __syncthreads();  // the list complete

  // 2. each listed cell's adjacency words
  for (int q = tid; q < nd; q += nt) {
    const int i = list[q];
    const int x = i % gx, y = (i / gx) % gy, z = i / (gx * gy);
    const T ci[3] = {cx[i], cy[i], cz[i]};
    for (int w = 0; w < W; ++w) {
      uint32_t word = 0u;
      for (int b = 0; b < 32; ++b) {
        const int o = 32 * w + b;
        if (o >= n_off) break;
        const int xx = x + s_dx[o], yy = y + s_dy[o], zz = z + s_dz[o];
        if (xx < 0 || xx >= gx || yy < 0 || yy >= gy || zz < 0 || zz >= gz) continue;
        const int j = i + s_delta[o];
        if (!dv[j]) continue;
        const T dx = fp::sub(ci[0], cx[j]), dy = fp::sub(ci[1], cy[j]), dz = fp::sub(ci[2], cz[j]);
        const T d2 = fp::fma(dz, dz, fp::fma(dx, dx, fp::mul(dy, dy)));
        if (d2 <= tol2) word |= 1u << b;
      }
      adj[(size_t)q * W + w] = word;
    }
  }
  __syncthreads();  // the labels and the words complete

  // 3. the iterations, Jacobi between lab_a and lab_b
  int* src = lab_a;
  int* dst = lab_b;
  int it = 0;
  bool changed = true;
  while (changed && it < max_iters) {
    if (tid == 0) s_changed = 0;
    __syncthreads();
    for (int p = 0; p < sweeps + jumps; ++p) {
      const bool sweep = p < sweeps;
      bool moved = false;
      for (int q = tid; q < nd; q += nt) {
        const int i = list[q];
        const int old = src[i];
        int v = old;
        if (sweep) {
          for (int w = 0; w < W; ++w) {
            uint32_t word = adj[(size_t)q * W + w];
            while (word) {
              const int o = 32 * w + __ffs(word) - 1;
              word &= word - 1u;
              v = min(v, src[i + s_delta[o]]);
            }
          }
        } else {
          v = src[old];
        }
        dst[i] = v;
        moved |= v != old;
      }
      if (moved) s_changed = 1;
      __syncthreads();
      int* t = src;
      src = dst;
      dst = t;
    }
    changed = s_changed != 0;
    ++it;
    __syncthreads();  // every thread read s_changed before the next reset
  }
  if (src != lab_a)
    for (int q = tid; q < nd; q += nt) lab_a[list[q]] = src[list[q]];
  if (tid == 0) {
    nsw[2 * f] = it * sweeps;
    nsw[2 * f + 1] = (changed && it >= max_iters) ? 1 : 0;
  }
}

template <class T>
int launch(const T* cent, const uint8_t* dyn, int S, int gx, int gy, int gz, const int* offsets,
           int n_off, T tol2, int max_iters, int sweeps, int jumps, int* labels, int* nsw,
           int* scratch, void* stream) {
  if (S < 1 || gx < 1 || gy < 1 || gz < 1 || n_off < 0 || n_off > kMaxOffsets || max_iters < 0 ||
      sweeps < 0 || jumps < 0 || (n_off > 0 && offsets == nullptr) || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  stencil_cc_kernel<T><<<S, kThreads, 0, (cudaStream_t)stream>>>(
      cent, dyn, gx, gy, gz, offsets, n_off, tol2, max_iters, sweeps, jumps, labels, nsw,
      scratch);
  return (int)cudaGetLastError();
}

}  // namespace

// S frames: cent (S, 3, n) f32 channel-major centroids, dyn (S, n) u8 (the
// cell holds a dynamic point), n = gx * gy * gz; offsets (n_off, 3) i32
// (dz, dy, dx) in device memory, n_off <= 256; tol2 = tol^2 in f32; the
// schedule max_iters, sweeps, jumps.  Outputs: labels (S, n) i32, nsw (S,
// 2) i32 [n_sweeps, saturated].  scratch: S * n * (2 + ceil(n_off / 32))
// int32 of device memory.
extern "C" int motl_stencil_cc(const float* cent, const uint8_t* dyn, int S, int gx, int gy,
                               int gz, const int* offsets, int n_off, float tol2, int max_iters,
                               int sweeps, int jumps, int* labels, int* nsw, int* scratch,
                               void* stream) {
  return launch(cent, dyn, S, gx, gy, gz, offsets, n_off, tol2, max_iters, sweeps, jumps, labels,
                nsw, scratch, stream);
}

// The double build: cent (S, 3, n) f64, tol2 in f64; the rest as
// motl_stencil_cc.
extern "C" int motl_stencil_cc_f64(const double* cent, const uint8_t* dyn, int S, int gx, int gy,
                                   int gz, const int* offsets, int n_off, double tol2,
                                   int max_iters, int sweeps, int jumps, int* labels, int* nsw,
                                   int* scratch, void* stream) {
  return launch(cent, dyn, S, gx, gy, gz, offsets, n_off, tol2, max_iters, sweeps, jumps, labels,
                nsw, scratch, stream);
}
