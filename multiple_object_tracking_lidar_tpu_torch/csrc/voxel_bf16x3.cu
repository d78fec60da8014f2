// K6: bf16x3 voxel accumulator in a fixed summation order.
//
// Replaces the Pallas kernel multiple_object_tracking_lidar_tpu/ops/
// voxel_grid.py::_accumulate_pallas_v2 (body _acc_kernel_v2), which exact
// mode takes when the leaf is too coarse for two int8 digits
// (_v3_leaf_ok fails), and the jnp bf16x3 lowering of the same sums
// (voxel_grid.py:256-278) that exact mode takes when no point block tiles N.
// Per kept point (mask nonzero, in bounds, not NaN: tested on the float
// floor before any cast) each coordinate v splits into three bf16 parts,
// round-to-nearest-even: h1 = bf16(v), h2 = bf16(v - h1),
// h3 = bf16((v - h1) - h2).  Per cell: the f32 sums S1, S2, S3 of each
// part, combined as (S1 + S2) + S3, and the exact count.
//
// The summation order.  The TPU sums in the MXU's own f32 order, which has
// no counterpart to copy, and float atomics would change the bits from run
// to run.  So K6 fixes its own order: per cell, each of the nine part sums
// starts at +0.0f and adds the cell's points one at a time in ASCENDING
// POINT INDEX, each add rounded to nearest (__fadd_rn).  The plain PyTorch
// version (ops/voxel_grid_cuda.py) runs the same adds in the same order.
//
// How the order is reached, in four kernels:
//  1. key/count: grid (chunks of 2,048 points, S); each point's cell key
//     (-1 when dropped) and integer-atomic counts per (cell, chunk);
//  2. scan: one CTA per frame, exclusive scan of the counts laid out
//     cell-major, chunk-minor (warp-cooperative, coalesced): the offset of
//     every (cell, chunk) run and the start of every cell;
//  3. scatter: one warp per chunk walks its points in index order, 32 at a
//     time; __match_any_sync ranks equal keys by lane, the group's lowest
//     lane advances the (cell, chunk) counter, which only this warp owns.
//     So the sorted list holds each cell's points in ascending index: a
//     stable counting sort, deterministic without float atomics;
//  4. sum: one thread per (frame, cell) walks its run in order.
//
// What bounds it on the H100: the serial per-cell walk.  A cell with m
// points takes m dependent f32 adds (nine independent chains), so one dense
// cell sets the kernel's time; the point traffic itself is ~3 reads of
// 12 bytes per point.  The design keeps the fixed order (it is the
// contract) and spreads cells over threads; the per-(cell, chunk) counters
// live in global memory, so unlike K1/K5 there is no shared-memory bound on
// the grid size.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct BfParams {
  int gx, gy, gz, bx, by, bz, n_cells;
  float inv_xy, inv_z;  // f32(1/leaf): f64 constants cast to f32
};

__device__ __forceinline__ float bf16_rne(float v) {
  // round-to-nearest-even to the top 16 bits (finite inputs only)
  unsigned u = __float_as_uint(v);
  u += 0x7FFFu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xFFFF0000u);
}

__global__ void bf_key_count_kernel(const float* __restrict__ pts,
                                    const uint8_t* __restrict__ mask, int n,
                                    int chunk, int n_chunks, BfParams p,
                                    int* __restrict__ keys,
                                    int* __restrict__ counts) {
  const int s = blockIdx.y;
  const int c = blockIdx.x;
  const float* P = pts + (size_t)s * n * 3;
  const uint8_t* M = mask + (size_t)s * n;
  int* K = keys + (size_t)s * n;
  int* C = counts + (size_t)s * p.n_cells * n_chunks;
  const int end = min(n, (c + 1) * chunk);
  for (int i = c * chunk + threadIdx.x; i < end; i += blockDim.x) {
    int key = -1;
    if (M[i] != 0) {
      const float fx = floorf(__fmul_rn(P[3 * i], p.inv_xy));
      const float fy = floorf(__fmul_rn(P[3 * i + 1], p.inv_xy));
      const float fz = floorf(__fmul_rn(P[3 * i + 2], p.inv_z));
      // bounds on the float floor, before any cast: NaN fails every compare
      if (fx >= (float)p.bx && fx < (float)(p.bx + p.gx) &&
          fy >= (float)p.by && fy < (float)(p.by + p.gy) &&
          fz >= (float)p.bz && fz < (float)(p.bz + p.gz)) {
        key = ((int)fx - p.bx) + p.gx * (((int)fy - p.by) + p.gy * ((int)fz - p.bz));
        atomicAdd(&C[(size_t)key * n_chunks + c], 1);
      }
    }
    K[i] = key;
  }
}

// One CTA of 32 warps per frame: exclusive scan of L = n_cells * n_chunks
// counts into offs; cell_start[cell] = offs[cell * n_chunks],
// cell_start[n_cells] = the frame's kept-point total.  Warp w owns one
// contiguous segment and walks it in coalesced 32-wide steps: a shuffle
// sum per step, then (after the 32 segment totals are scanned) a shuffle
// scan per step.  Integer adds: exact in any order.
__global__ void __launch_bounds__(1024) bf_scan_kernel(const int* __restrict__ counts,
                                                       int* __restrict__ offs,
                                                       int* __restrict__ cell_start,
                                                       int n_cells, int n_chunks) {
  __shared__ int warp_base[32];
  __shared__ int total;
  const int s = blockIdx.x;
  const int L = n_cells * n_chunks;
  const int* C = counts + (size_t)s * L;
  int* O = offs + (size_t)s * L;
  int* CS = cell_start + (size_t)s * (n_cells + 1);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int seg = ((L + 31) / 32 + 31) / 32 * 32;  // a multiple of 32
  const int lo = min(L, w * seg), hi = min(L, lo + seg);
  int sum = 0;
  for (int j = lo + lane; j < hi; j += 32) sum += C[j];
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (lane == 0) warp_base[w] = sum;
  __syncthreads();
  if (w == 0) {  // exclusive scan of the 32 segment totals
    const int v = warp_base[lane];
    int inc = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += u;
    }
    warp_base[lane] = inc - v;
    if (lane == 31) total = inc;
  }
  __syncthreads();
  int run = warp_base[w];
  for (int j0 = lo; j0 < hi; j0 += 32) {
    const int j = j0 + lane;
    const int v = j < hi ? C[j] : 0;
    int inc = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += u;
    }
    if (j < hi) {
      const int ex = run + inc - v;
      O[j] = ex;
      if (j % n_chunks == 0) CS[j / n_chunks] = ex;
    }
    run += __shfl_sync(0xffffffffu, inc, 31);
  }
  if (threadIdx.x == 0) CS[n_cells] = total;
}

// One warp per chunk: stable placement of the chunk's kept points.
__global__ void bf_scatter_kernel(const int* __restrict__ keys, int n,
                                  int chunk, int n_chunks, int n_cells,
                                  int* __restrict__ offs,
                                  int* __restrict__ sorted) {
  const int s = blockIdx.y;
  const int c = blockIdx.x;
  const int lane = threadIdx.x;
  const int* K = keys + (size_t)s * n;
  int* O = offs + (size_t)s * n_cells * n_chunks;
  int* SO = sorted + (size_t)s * n;
  const int end = min(n, (c + 1) * chunk);
  for (int base = c * chunk; base < end; base += 32) {
    const int i = base + lane;
    const int key = i < end ? K[i] : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    const int leader = __ffs(peers) - 1;
    int pos = 0;
    if (key >= 0 && lane == leader) pos = O[(size_t)key * n_chunks + c];
    pos = __shfl_sync(0xffffffffu, pos, leader);
    if (key >= 0) {
      SO[pos + __popc(peers & ((1u << lane) - 1u))] = i;
      if (lane == leader) O[(size_t)key * n_chunks + c] = pos + __popc(peers);
    }
    __syncwarp();  // the counter written above is read by the next round
  }
}

__global__ void bf_sum_kernel(const float* __restrict__ pts,
                              const int* __restrict__ sorted,
                              const int* __restrict__ cell_start, int S,
                              int n, int n_cells, float* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= S * n_cells) return;
  const int s = t / n_cells, cell = t - s * n_cells;
  const float* P = pts + (size_t)s * n * 3;
  const int* SO = sorted + (size_t)s * n;
  const int* CS = cell_start + (size_t)s * (n_cells + 1);
  const int lo = CS[cell], hi = CS[cell + 1];
  float acc[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) acc[k] = 0.0f;
  for (int j = lo; j < hi; ++j) {
    const int i = SO[j];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float v = P[3 * i + a];
      const float h1 = bf16_rne(v);
      const float r1 = __fsub_rn(v, h1);
      const float h2 = bf16_rne(r1);
      const float h3 = bf16_rne(__fsub_rn(r1, h2));
      acc[3 * a] = __fadd_rn(acc[3 * a], h1);
      acc[3 * a + 1] = __fadd_rn(acc[3 * a + 1], h2);
      acc[3 * a + 2] = __fadd_rn(acc[3 * a + 2], h3);
    }
  }
  float* O = out + (size_t)s * 4 * n_cells;
#pragma unroll
  for (int a = 0; a < 3; ++a)
    O[a * n_cells + cell] = __fadd_rn(__fadd_rn(acc[3 * a], acc[3 * a + 1]), acc[3 * a + 2]);
  O[3 * n_cells + cell] = (float)(hi - lo);
}

}  // namespace

// points (S, N, 3) f32, mask (S, N) u8.  Scratch from the caller: keys
// (S, N) i32, counts (S, n_cells * n_chunks) i32 zeroed, offs the same
// shape, cell_start (S, n_cells + 1) i32, sorted (S, N) i32.  Output
// out (S, 4, n_cells) f32 [sum_x, sum_y, sum_z, count].
extern "C" int motl_voxel_bf16x3(
    const float* pts, const uint8_t* mask, int S, int N, int chunk,
    int* keys, int* counts, int* offs, int* cell_start, int* sorted,
    float* out, int n_cells, int gx, int gy, int gz, int bx, int by, int bz,
    float inv_xy, float inv_z, void* stream) {
  BfParams p{gx, gy, gz, bx, by, bz, n_cells, inv_xy, inv_z};
  cudaStream_t st = (cudaStream_t)stream;
  const int n_chunks = (N + chunk - 1) / chunk;
  bf_key_count_kernel<<<dim3(n_chunks, S), 256, 0, st>>>(
      pts, mask, N, chunk, n_chunks, p, keys, counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bf_scan_kernel<<<S, 1024, 0, st>>>(counts, offs, cell_start, n_cells, n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bf_scatter_kernel<<<dim3(n_chunks, S), 32, 0, st>>>(
      keys, N, chunk, n_chunks, n_cells, offs, sorted);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = S * n_cells;
  bf_sum_kernel<<<(total + 127) / 128, 128, 0, st>>>(
      pts, sorted, cell_start, S, N, n_cells, out);
  return (int)cudaGetLastError();
}
