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
// (2 x 10.2 MB for S = 8 headline frames).  Design: one CTA per (TR x TC)
// tile of one frame, staged in shared memory so that both the read and the
// write are coalesced.  TC = min(C, 32) columns; TR = 32 * (32 / TC) rows,
// so a narrow C (3 for points) still gives each CTA ~1,000 words: its read
// is then TR whole rows, one contiguous run.  The tile's row pitch is TC
// rounded up to odd, so the column-wise read-back walks distinct banks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTileCols = 32;

__global__ void transpose32_kernel(const uint32_t* __restrict__ in,
                                   uint32_t* __restrict__ out, int R, int C,
                                   int TR, int TC) {
  extern __shared__ uint32_t tile[];  // (TR, TC | 1)
  const int pitch = TC | 1;
  const int r0 = blockIdx.x * TR, c0 = blockIdx.y * TC, s = blockIdx.z;
  const int nr = min(TR, R - r0), nc = min(TC, C - c0);
  const uint32_t* X = in + (size_t)s * R * C;
  uint32_t* Y = out + (size_t)s * R * C;
  // read: consecutive threads take consecutive words of a row segment
  for (int i = threadIdx.x; i < nr * nc; i += blockDim.x) {
    const int r = i / nc, c = i - r * nc;
    tile[r * pitch + c] = X[(size_t)(r0 + r) * C + c0 + c];
  }
  __syncthreads();
  // write: consecutive threads take consecutive words of an output row
  for (int i = threadIdx.x; i < nr * nc; i += blockDim.x) {
    const int c = i / nr, r = i - c * nr;
    Y[(size_t)(c0 + c) * R + r0 + r] = tile[r * pitch + c];
  }
}

}  // namespace

// in (S, R, C) and out (S, C, R), 32-bit words; 1 <= S, R, C.  The wrapper
// keeps the grid inside the device's limits (row tiles on x, column tiles
// and frames on y and z, each <= 65,535).
extern "C" int motl_transpose32(const void* in, void* out, int S, int R, int C,
                                void* stream) {
  if (S < 1 || R < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const int TC = C < kMaxTileCols ? C : kMaxTileCols;
  const int TR = 32 * (kMaxTileCols / TC);
  const dim3 grid((R + TR - 1) / TR, (C + TC - 1) / TC, S);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)TR * (TC | 1) * sizeof(uint32_t);
  transpose32_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, R, C, TR, TC);
  return (int)cudaGetLastError();
}
