// K11: batched transpose of 32-bit words, (S, R, C) -> (S, C, R).
//
// Replaces the Pallas probes scripts/micro_transpose.py::run (:49), which
// time Mosaic's in-kernel transpose of a (1, B) int32 row into a (B, 1)
// column (_kernel_direct; _kernel_tiled through (16, 128) -> (128, 16)):
// the layout change that would let the TPU's v7 accumulator
// (scripts/micro_acc_v7.py) derive its one-hot from one channel-major read.
// On the card the same question is the (S, N, 3) -> (S, 3, N) conversion
// of the points that K1-cm reads (scripts/micro_torch_acc.py); the probes'
// own shapes are this function at (1, 1, B) and (1, 16, 128).  It moves
// words and computes nothing, so its output is x.transpose(1, 2)
// .contiguous() bit for bit, for float32 and int32 alike.
//
// What bounds it on the H100: bytes -- each word read once and written once
// (2 x 10.2 MB for S = 8 headline frames, 6.1 us at 3.35 TB/s).  Design, one
// launch per call, one of three routes by shape:
//  * narrow rows (2 <= C <= 4, the points' C = 3): no shared memory.  A
//    thread owns groups of 4 consecutive rows (4 per thread, a CTA's groups
//    contiguous); a group is 4C contiguous words, read as C 16-byte loads,
//    and written as C 16-byte stores, one to each output plane c at row 4g
//    -- a warp's store to a plane is 512 contiguous bytes, its C loads 32 x
//    4C contiguous words (their sectors shared through L1).  No division:
//    frames are the grid's y.  A load or store whose address is not 16-byte
//    aligned (a frame base when R C % 4 != 0 or the input pointer is
//    misaligned, a plane base when R % 4 != 0) moves its 4 words one by
//    one; the R % 4 rows past the last whole group are moved word by word
//    by the frame's first CTA;
//  * R == 1 or C == 1: the word order does not change, so the call is a
//    copy, 16 bytes a thread-step where both pointers allow it;
//  * wider rows (C > 4, the tiled probe's (16, 128)): 32 x 32 tiles through
//    shared memory at a pitch of 33 words (the column-wise read-back walks
//    32 distinct banks), each row of a tile read and each output row
//    written as 8 16-byte accesses where aligned and whole, word by word
//    at a ragged or misaligned edge.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // narrow route and copy
constexpr int kGroups = 4;     // 4-row groups (narrow) or 16-byte steps (copy) per thread
constexpr int kTile = 32;      // wide route: 32 x 32 tiles, 256 threads

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

__device__ __forceinline__ uint32_t word(const uint4& a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}

__device__ __forceinline__ uint4 load4(const uint32_t* p, bool vec) {
  return vec ? *reinterpret_cast<const uint4*>(p) : make_uint4(p[0], p[1], p[2], p[3]);
}

__device__ __forceinline__ void store4(uint32_t* p, const uint4& a, bool vec) {
  if (vec) {
    *reinterpret_cast<uint4*>(p) = a;
  } else {
    p[0] = a.x; p[1] = a.y; p[2] = a.z; p[3] = a.w;
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads)
transpose_narrow_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, int R) {
  const size_t frame = (size_t)blockIdx.y * R * C;
  const uint32_t* X = in + frame;
  uint32_t* Y = out + frame;
  const int full = R >> 2;  // whole 4-row groups
  const int g0 = blockIdx.x * (kThreads * kGroups) + threadIdx.x;
  const bool xv = aligned16(X);
  bool yv[C];
#pragma unroll
  for (int c = 0; c < C; ++c) yv[c] = aligned16(Y + (size_t)c * R);
  uint4 v[kGroups][C];
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
    const int g = g0 + j * kThreads;
    if (g < full) {
#pragma unroll
      for (int q = 0; q < C; ++q) v[j][q] = load4(X + (size_t)g * 4 * C + 4 * q, xv);
    }
  }
  // word w of a group is row 4g + w / C, column w % C: plane c takes the
  // group's words c, C + c, 2C + c, 3C + c
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
    const int g = g0 + j * kThreads;
    if (g < full) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const uint4 o = make_uint4(word(v[j][c / 4], c % 4), word(v[j][(C + c) / 4], (C + c) % 4),
                                   word(v[j][(2 * C + c) / 4], (2 * C + c) % 4),
                                   word(v[j][(3 * C + c) / 4], (3 * C + c) % 4));
        store4(Y + (size_t)c * R + 4 * g, o, yv[c]);
      }
    }
  }
  const int edge = (R & 3) * C;  // the rows past the last whole group
  if (blockIdx.x == 0 && (int)threadIdx.x < edge) {
    const int r = 4 * full + (int)threadIdx.x / C, c = (int)threadIdx.x % C;
    Y[(size_t)c * R + r] = X[(size_t)r * C + c];
  }
}

__global__ void __launch_bounds__(kThreads)
copy_words_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, size_t n) {
  const size_t n4 = n >> 2;
  const bool vec = aligned16(in) && aligned16(out);
  const size_t i0 = (size_t)blockIdx.x * (kThreads * kGroups) + threadIdx.x;
  uint4 v[kGroups];
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
    const size_t i = i0 + (size_t)j * kThreads;
    if (i < n4) v[j] = load4(in + 4 * i, vec);
  }
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
    const size_t i = i0 + (size_t)j * kThreads;
    if (i < n4) store4(out + 4 * i, v[j], vec);
  }
  if (blockIdx.x == 0 && threadIdx.x < (n & 3)) out[4 * n4 + threadIdx.x] = in[4 * n4 + threadIdx.x];
}

__global__ void __launch_bounds__(kTile * kTile / 4)
transpose_tiled_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, int R,
                       int C) {
  __shared__ uint32_t tile[kTile][kTile + 1];
  const int r0 = blockIdx.x * kTile, c0 = blockIdx.y * kTile;
  const size_t frame = (size_t)blockIdx.z * R * C;
  const uint32_t* X = in + frame;
  uint32_t* Y = out + frame;
  const int tr = threadIdx.x >> 3, tq = (threadIdx.x & 7) * 4;  // 8 threads x 4 words per row
  // read: tile row tr is input row r0 + tr, columns c0 + tq .. + 3
  if (r0 + tr < R) {
    const uint32_t* p = X + (size_t)(r0 + tr) * C + c0 + tq;
    if (c0 + tq + 4 <= C && aligned16(p)) {
      const uint4 a = *reinterpret_cast<const uint4*>(p);
      tile[tr][tq] = a.x; tile[tr][tq + 1] = a.y; tile[tr][tq + 2] = a.z; tile[tr][tq + 3] = a.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (c0 + tq + k < C) tile[tr][tq + k] = p[k];
    }
  }
  __syncthreads();
  // write: output row (plane) c0 + tr, rows r0 + tq .. + 3
  if (c0 + tr < C) {
    uint32_t* q = Y + (size_t)(c0 + tr) * R + r0 + tq;
    if (r0 + tq + 4 <= R && aligned16(q)) {
      *reinterpret_cast<uint4*>(q) =
          make_uint4(tile[tq][tr], tile[tq + 1][tr], tile[tq + 2][tr], tile[tq + 3][tr]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (r0 + tq + k < R) q[k] = tile[tq + k][tr];
    }
  }
}

}  // namespace

// in (S, R, C) and out (S, C, R), 32-bit words; 1 <= S, R, C; out 16-byte
// aligned.  S <= 65,535 (a grid dimension) and, past C = 4, C <= 32 x
// 65,535; the wrapper checks both.
extern "C" int motl_transpose32(const void* in, void* out, int S, int R, int C,
                                void* stream) {
  if (S < 1 || R < 1 || C < 1 || S > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* x = (const uint32_t*)in;
  uint32_t* y = (uint32_t*)out;
  constexpr int per_cta = kThreads * kGroups;
  if (R == 1 || C == 1) {
    const size_t n = (size_t)S * R * C;
    const size_t ctas = ((n >> 2) + per_cta - 1) / per_cta;
    copy_words_kernel<<<(unsigned)(ctas > 0 ? ctas : 1), kThreads, 0, st>>>(x, y, n);
  } else if (C <= 4) {
    const int ctas = ((R >> 2) + per_cta - 1) / per_cta;
    const dim3 grid(ctas > 0 ? ctas : 1, S);
    if (C == 2) transpose_narrow_kernel<2><<<grid, kThreads, 0, st>>>(x, y, R);
    else if (C == 3) transpose_narrow_kernel<3><<<grid, kThreads, 0, st>>>(x, y, R);
    else transpose_narrow_kernel<4><<<grid, kThreads, 0, st>>>(x, y, R);
  } else {
    const dim3 grid((R + kTile - 1) / kTile, (C + kTile - 1) / kTile, S);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    transpose_tiled_kernel<<<grid, kTile * kTile / 4, 0, st>>>(x, y, R, C);
  }
  return (int)cudaGetLastError();
}
