// K6: voxel sums in a fixed summation order -- bf16x3 mode and f32 mode.
//
// Mode 0 (bf16x3) replaces the Pallas kernel multiple_object_tracking_lidar_
// tpu/ops/voxel_grid.py::_accumulate_pallas_v2 (body _acc_kernel_v2), which
// exact mode takes when the leaf is too coarse for two int8 digits
// (_v3_leaf_ok fails), and the jnp bf16x3 lowering of the same sums
// (voxel_grid.py:256-278) that exact mode takes when no point block tiles N.
// Per kept point (mask nonzero, in bounds, not NaN: tested on the float
// floor before any cast) each coordinate v splits into three bf16 parts,
// round-to-nearest-even: h1 = bf16(v), h2 = bf16(v - h1),
// h3 = bf16((v - h1) - h2).  Per cell: the f32 sums S1, S2, S3 of each
// part, combined as (S1 + S2) + S3, and the exact count.
//
// The key entry (motl_voxel_bf16x3_keys) replaces the Pallas kernel
// voxel_grid.py::_accumulate_pallas (body _acc_kernel), the TPU's first
// one-hot accumulator, whose caller quantizes: it takes precomputed ix,
// iyz and in_bounds and sums the same bf16x3 parts over the (gyz, gx) grid.
// Its stage 1 takes the key in_bounds ? iyz * gx + ix : -1 instead of
// quantizing, and drops ix outside [0, gx) and iyz outside [0, gyz): no
// one-hot row matches them (voxel_grid.py:314-317).  Stages 2-4 are shared.
//
// Mode 1 (f32) is the point-list dense accumulator, ops/voxel.py::
// voxel_accumulate: no Pallas kernel, an XLA scatter-add of (x, y, z, 1),
// which XLA's CPU code applies one update at a time in ascending point
// index.  Per cell: the plain f32 sum of each coordinate and the count.
//
// The summation order.  Float atomics would change the bits from run to
// run, and the TPU's MXU order (mode 0) has no counterpart to copy.  So K6
// fixes its order: per cell, each sum starts at +0.0f and adds the cell's
// points one at a time in ASCENDING POINT INDEX, each add rounded to
// nearest (__fadd_rn) -- in mode 1 exactly the scatter-add's order.  The
// plain PyTorch versions (ops/voxel_grid_cuda.py) run the same adds in the
// same order.
//
// How the order is reached:
//  1. key/count: grid (chunks of `chunk` points, S); each point's cell key
//     (-1 when dropped) and integer-atomic counts per (cell, chunk);
//  2. scan, three kernels: the exclusive scan of the counts laid out
//     cell-major, chunk-minor, cut into up to 1,024 segments per frame
//     (segment totals, their scan, each segment's own warp-cooperative,
//     coalesced scan): the offset of every (cell, chunk) run and the start
//     of every cell;
//  3. scatter: one warp per chunk walks its points in index order, 32 at a
//     time; __match_any_sync ranks equal keys by lane, the group's lowest
//     lane advances the (cell, chunk) counter, which only this warp owns.
//     So the sorted list holds each cell's points in ascending index: a
//     stable counting sort, deterministic without float atomics;
//  4. sum: one thread per (frame, cell) walks its run in order.
//
// What bounds it on the H100: the serial per-cell walk.  A cell with m
// points takes m dependent f32 adds, so one dense cell sets the kernel's
// time; the point traffic itself is ~3 reads of 12 bytes per point.  The
// design keeps the fixed order (it is the contract) and spreads cells over
// threads.  The per-(cell, chunk) counters live in global memory, so there
// is no shared-memory bound on the grid size, but they grow with it: at the
// JAX package's default configuration (0.05 m leaf, 96 x 224 x 9 =
// 193,536 cells, N = 131,072 in 64 chunks of 2,048) the counts and their
// offsets take 193,536 * 64 * 4 B = 49.5 MB each per frame.  The scan is
// therefore spread over up to 1,024 CTAs per frame (a single CTA would walk
// 12.4 M counts in series); the memory stays, 0.8 GB for both arrays at
// S = 8 of the card's 80 GB.  (The wrapper doubles the chunk where the
// counters would pass 2^26 per frame.)

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

// Stage 1 of the key entry: the keys given as grid indices.
__global__ void bf_key_count_idx_kernel(const int* __restrict__ ix,
                                        const int* __restrict__ iyz,
                                        const uint8_t* __restrict__ inb, int n,
                                        int chunk, int n_chunks, int gx, int gyz,
                                        int* __restrict__ keys,
                                        int* __restrict__ counts) {
  const int s = blockIdx.y;
  const int c = blockIdx.x;
  const int* X = ix + (size_t)s * n;
  const int* YZ = iyz + (size_t)s * n;
  const uint8_t* B = inb + (size_t)s * n;
  int* K = keys + (size_t)s * n;
  int* C = counts + (size_t)s * gx * gyz * n_chunks;
  const int end = min(n, (c + 1) * chunk);
  for (int i = c * chunk + threadIdx.x; i < end; i += blockDim.x) {
    int key = -1;
    const int x = X[i], yz = YZ[i];
    if (B[i] != 0 && x >= 0 && x < gx && yz >= 0 && yz < gyz) {
      key = yz * gx + x;
      atomicAdd(&C[(size_t)key * n_chunks + c], 1);
    }
    K[i] = key;
  }
}

// The exclusive scan of the L = n_cells * n_chunks counts of each frame
// runs over n_seg segments of seg_len counts, in three kernels: the total
// of every segment (grid (n_seg, S)), the exclusive scan of those totals
// (one CTA per frame, n_seg <= 1024), then every segment's own scan from its
// base (grid (n_seg, S)).  offs gets the exclusive prefix of every
// (cell, chunk) count; cell_start[cell] = offs[cell * n_chunks],
// cell_start[n_cells] = the frame's kept-point total.  Integer adds: exact
// in any order.
__global__ void __launch_bounds__(256) bf_seg_total_kernel(const int* __restrict__ counts,
                                                           int L, int seg_len, int n_seg,
                                                           int* __restrict__ seg_tot) {
  __shared__ int warp_sum[8];
  const int s = blockIdx.y, g = blockIdx.x;
  const int* C = counts + (size_t)s * L;
  const int lo = min(L, g * seg_len), hi = min(L, lo + seg_len);
  int sum = 0;
  for (int j = lo + threadIdx.x; j < hi; j += blockDim.x) sum += C[j];
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
    for (int w = 0; w < 8; ++w) t += warp_sum[w];
    seg_tot[(size_t)s * n_seg + g] = t;
  }
}

__global__ void __launch_bounds__(1024) bf_seg_base_kernel(const int* __restrict__ seg_tot,
                                                           int n_seg, int n_cells,
                                                           int* __restrict__ seg_base,
                                                           int* __restrict__ cell_start) {
  __shared__ int warp_base[32];
  const int s = blockIdx.x;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int v = threadIdx.x < n_seg ? seg_tot[(size_t)s * n_seg + threadIdx.x] : 0;
  int inc = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += u;
  }
  if (lane == 31) warp_base[w] = inc;
  __syncthreads();
  if (w == 0) {  // exclusive scan of the 32 warp totals
    const int t = warp_base[lane];
    int tinc = t;
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, tinc, o);
      if (lane >= o) tinc += u;
    }
    warp_base[lane] = tinc - t;
    if (lane == 31) cell_start[(size_t)s * (n_cells + 1) + n_cells] = tinc;
  }
  __syncthreads();
  if (threadIdx.x < n_seg) seg_base[(size_t)s * n_seg + threadIdx.x] = warp_base[w] + inc - v;
}

// One CTA of 32 warps per (segment, frame).  Warp w owns one contiguous
// sub-segment and walks it in coalesced 32-wide steps: a shuffle sum per
// step, then (after the 32 sub-segment totals are scanned) a shuffle scan
// per step.
__global__ void __launch_bounds__(1024) bf_scan_kernel(const int* __restrict__ counts,
                                                       int L, int seg_len, int n_seg,
                                                       const int* __restrict__ seg_base,
                                                       int* __restrict__ offs,
                                                       int* __restrict__ cell_start,
                                                       int n_cells, int n_chunks) {
  __shared__ int warp_base[32];
  const int s = blockIdx.y, g = blockIdx.x;
  const int* C = counts + (size_t)s * L;
  int* O = offs + (size_t)s * L;
  int* CS = cell_start + (size_t)s * (n_cells + 1);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g_lo = min(L, g * seg_len), g_hi = min(L, g_lo + seg_len);
  const int sub = ((g_hi - g_lo + 31) / 32 + 31) / 32 * 32;  // a multiple of 32
  const int lo = min(g_hi, g_lo + w * sub), hi = min(g_hi, lo + sub);
  int sum = 0;
  for (int j = lo + lane; j < hi; j += 32) sum += C[j];
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (lane == 0) warp_base[w] = sum;
  __syncthreads();
  if (w == 0) {  // exclusive scan of the 32 sub-segment totals
    const int v = warp_base[lane];
    int inc = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += u;
    }
    warp_base[lane] = inc - v;
  }
  __syncthreads();
  int run = seg_base[(size_t)s * n_seg + g] + warp_base[w];
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

// f32 mode: the plain coordinates, one sum per axis from +0.0f, the
// cell's points in ascending index.
__global__ void f32_sum_kernel(const float* __restrict__ pts,
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
  float ax = 0.0f, ay = 0.0f, az = 0.0f;
  for (int j = lo; j < hi; ++j) {
    const int i = SO[j];
    ax = __fadd_rn(ax, P[3 * i]);
    ay = __fadd_rn(ay, P[3 * i + 1]);
    az = __fadd_rn(az, P[3 * i + 2]);
  }
  float* O = out + (size_t)s * 4 * n_cells;
  O[cell] = ax;
  O[n_cells + cell] = ay;
  O[2 * n_cells + cell] = az;
  O[3 * n_cells + cell] = (float)(hi - lo);
}

// Stages 2-4 of both entries, after stage 1 has written keys and counts.
int launch_sorted_sums(const float* pts, int S, int N, int chunk, int n_cells, int* keys,
                       int* counts, int* offs, int* cell_start, int* sorted, int* seg_tot,
                       int* seg_base, int seg_len, float* out, int mode, cudaStream_t st) {
  const int n_chunks = (N + chunk - 1) / chunk;
  const int L = n_cells * n_chunks;
  const int n_seg = (L + seg_len - 1) / seg_len;
  bf_seg_total_kernel<<<dim3(n_seg, S), 256, 0, st>>>(counts, L, seg_len, n_seg, seg_tot);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bf_seg_base_kernel<<<S, 1024, 0, st>>>(seg_tot, n_seg, n_cells, seg_base, cell_start);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bf_scan_kernel<<<dim3(n_seg, S), 1024, 0, st>>>(counts, L, seg_len, n_seg, seg_base, offs,
                                                  cell_start, n_cells, n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bf_scatter_kernel<<<dim3(n_chunks, S), 32, 0, st>>>(
      keys, N, chunk, n_chunks, n_cells, offs, sorted);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = S * n_cells;
  if (mode == 0)
    bf_sum_kernel<<<(total + 127) / 128, 128, 0, st>>>(pts, sorted, cell_start, S, N, n_cells, out);
  else
    f32_sum_kernel<<<(total + 127) / 128, 128, 0, st>>>(pts, sorted, cell_start, S, N, n_cells, out);
  return (int)cudaGetLastError();
}

bool bad_shape(int N, int chunk, int n_cells, int seg_len) {
  if (N < 1 || chunk < 1 || n_cells < 1 || seg_len < 32 || seg_len % 32 != 0) return true;
  const long long L = (long long)n_cells * ((N + chunk - 1) / chunk);
  const long long n_seg = (L + seg_len - 1) / seg_len;
  return n_seg < 1 || n_seg > 1024;
}

}  // namespace

// points (S, N, 3) f32, mask (S, N) u8.  Scratch from the caller: keys
// (S, N) i32, counts (S, n_cells * n_chunks) i32 zeroed, offs the same
// shape, cell_start (S, n_cells + 1) i32, sorted (S, N) i32, seg_tot and
// seg_base (S, n_seg) i32 with n_seg = ceil(n_cells * n_chunks / seg_len)
// <= 1024.  Output out (S, 4, n_cells) f32 [sum_x, sum_y, sum_z, count]:
// mode 0 the bf16x3 sums, mode 1 the plain f32 sums.
extern "C" int motl_voxel_bf16x3(
    const float* pts, const uint8_t* mask, int S, int N, int chunk,
    int* keys, int* counts, int* offs, int* cell_start, int* sorted,
    int* seg_tot, int* seg_base, int seg_len, float* out, int n_cells,
    int gx, int gy, int gz, int bx, int by, int bz, float inv_xy, float inv_z,
    int mode, void* stream) {
  if (bad_shape(N, chunk, n_cells, seg_len) || (mode != 0 && mode != 1))
    return (int)cudaErrorInvalidValue;
  BfParams p{gx, gy, gz, bx, by, bz, n_cells, inv_xy, inv_z};
  cudaStream_t st = (cudaStream_t)stream;
  const int n_chunks = (N + chunk - 1) / chunk;
  bf_key_count_kernel<<<dim3(n_chunks, S), 256, 0, st>>>(
      pts, mask, N, chunk, n_chunks, p, keys, counts);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_sorted_sums(pts, S, N, chunk, n_cells, keys, counts, offs, cell_start, sorted,
                            seg_tot, seg_base, seg_len, out, mode, st);
}

// The key entry: ix, iyz (S, N) i32 and in_bounds (S, N) u8 instead of the
// mask and the grid geometry; n_cells = gyz * gx in iyz-major order.  The
// bf16x3 sums of mode 0; the same scratch and output as motl_voxel_bf16x3.
extern "C" int motl_voxel_bf16x3_keys(
    const float* pts, const int* ix, const int* iyz, const uint8_t* inb, int S, int N,
    int chunk, int* keys, int* counts, int* offs, int* cell_start, int* sorted,
    int* seg_tot, int* seg_base, int seg_len, float* out, int gx, int gyz, void* stream) {
  const int n_cells = gx * gyz;
  if (gx < 1 || gyz < 1 || bad_shape(N, chunk, n_cells, seg_len))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int n_chunks = (N + chunk - 1) / chunk;
  bf_key_count_idx_kernel<<<dim3(n_chunks, S), 256, 0, st>>>(
      ix, iyz, inb, N, chunk, n_chunks, gx, gyz, keys, counts);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_sorted_sums(pts, S, N, chunk, n_cells, keys, counts, offs, cell_start, sorted,
                            seg_tot, seg_base, seg_len, out, 0, st);
}
