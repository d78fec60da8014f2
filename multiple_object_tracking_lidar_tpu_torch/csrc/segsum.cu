// K7 and K9: segmented prefix totals over key-sorted rows.
//
// K9 replaces the Pallas kernel multiple_object_tracking_lidar_tpu/ops/
// voxel_pallas.py::segment_totals_pallas (body _segsum_kernel), K7's
// predecessor: the same tree over flat blocks of T = min(2048, N) rows,
// with the 4 channels of one (N, 4) array.  Everything below holds for it
// with that T and C = 4; one kernel template serves both, on the channel
// count and the channels' layout (K7: one array per channel; K9: rows of 4
// interleaved floats).  At T = 2,048 a block holds 40 KB of shared memory.
//
// K7 replaces the Pallas kernel multiple_object_tracking_lidar_tpu/ops/
// voxel_pallas.py::segment_totals_raster (body _segsum_raster_kernel), the
// segment sums of voxel_mode="runs".  Rows arrive sorted by cell key; row i
// of the output holds the sum of its run's rows up to and including i, so
// the last row of each run holds the run's total.
//
// It computes the Pallas kernel's exact float tree, so the result is
// bit-identical:
//  * per block of T = rb * 128 flat rows (rb = min(64, N / 128)), passes at
//    sh = 1, 2, ..., T/2 of  c_i <- c_i + c_{(i-sh) mod T} * same_i  with
//    same_i = [k_{(i-sh) mod T} == k_i and i >= sh] as 0.0f / 1.0f: the
//    TPU's rolls are cyclic inside the block, and the multiply-by-0/1 form
//    (not a branch) moves signed zeros, inf and NaN as the TPU does;
//  * for every block b > 0: out = c + [k == carry_key] * carry, over the
//    whole block, where carry_key and carry are block b-1's last key and
//    last OUTPUT (its own fold included) (voxel_pallas.py:295-312).
//
// What bounds it on the H100: a block's 13 passes each read and write its
// T rows, so they stay in shared memory (16 B per row, 128 KB at T = 8,192);
// device memory sees one read and one write per row.  The TPU walks the
// blocks in order and carries in scratch; on Hopper the blocks run in
// parallel, so the carry chain is a SECOND PASS: pass 1 (one CTA per block)
// writes each block's prefixes and its last key and last prefix; pass 2
// (one CTA per block b > 0) re-walks the b summaries before it, a serial
// chain of at most N / T - 1 steps done once per CTA by thread 0, and folds
// the carry into its block.  Every f32 op is __fmul_rn / __fadd_rn.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxPerThread = 8;  // T <= 8,192 = 8 * 1024

// Channel c of row r of frame s sits at base[c] + (s * n + r) * stride:
// K7 passes its three arrays with stride 1, K9 one (S, N, 4) array as four
// bases one float apart with stride 4.
template <int NC>
struct Chans {
  const float* in[NC];
  float* out[NC];
  int stride;
};

template <int NC>
__global__ void __launch_bounds__(kThreads) seg_block_kernel(const int* __restrict__ ks,
                                                             Chans<NC> ch, int n, int T,
                                                             int* __restrict__ last_key,
                                                             float* __restrict__ last_val) {
  extern __shared__ unsigned char smem[];
  int* K = reinterpret_cast<int*>(smem);
  float* C = reinterpret_cast<float*>(K + T);  // (NC, T)
  const int s = blockIdx.y, b = blockIdx.x, nb = gridDim.x;
  const size_t base = (size_t)s * n + (size_t)b * T;
  for (int i = threadIdx.x; i < T; i += kThreads) {
    K[i] = ks[base + i];
#pragma unroll
    for (int c = 0; c < NC; ++c) C[c * T + i] = ch.in[c][(base + i) * ch.stride];
  }
  __syncthreads();
  for (int sh = 1; sh < T; sh <<= 1) {
    float nv[NC][kMaxPerThread];
#pragma unroll
    for (int e = 0; e < kMaxPerThread; ++e) {
      const int i = threadIdx.x + e * kThreads;
      if (i < T) {
        const int j = (i - sh + T) % T;  // the cyclic roll
        const float same = (K[j] == K[i] && i >= sh) ? 1.0f : 0.0f;
#pragma unroll
        for (int c = 0; c < NC; ++c)
          nv[c][e] = __fadd_rn(C[c * T + i], __fmul_rn(C[c * T + j], same));
      }
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kMaxPerThread; ++e) {
      const int i = threadIdx.x + e * kThreads;
      if (i < T) {
#pragma unroll
        for (int c = 0; c < NC; ++c) C[c * T + i] = nv[c][e];
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < T; i += kThreads) {
#pragma unroll
    for (int c = 0; c < NC; ++c) ch.out[c][(base + i) * ch.stride] = C[c * T + i];
  }
  if (threadIdx.x == 0) {
    const size_t sb = (size_t)s * nb + b;
    last_key[sb] = K[T - 1];
    for (int c = 0; c < NC; ++c) last_val[NC * sb + c] = C[c * T + T - 1];
  }
}

template <int NC>
__global__ void seg_carry_kernel(const int* __restrict__ ks, Chans<NC> ch, int n, int T,
                                 const int* __restrict__ last_key,
                                 const float* __restrict__ last_val) {
  __shared__ int ck;
  __shared__ float carry[NC];
  const int s = blockIdx.y, b = blockIdx.x, nb = gridDim.x;
  if (b == 0) return;  // block 0 keeps its prefixes
  if (threadIdx.x == 0) {
    // carry into block 1 = block 0's last output = its last prefix
    const size_t s0 = (size_t)s * nb;
    int key = last_key[s0];
    float cv[NC];
    for (int c = 0; c < NC; ++c) cv[c] = last_val[NC * s0 + c];
    for (int bb = 1; bb < b; ++bb) {  // block bb's last output
      const size_t sb = s0 + bb;
      const float m = last_key[sb] == key ? 1.0f : 0.0f;
      for (int c = 0; c < NC; ++c) cv[c] = __fadd_rn(last_val[NC * sb + c], __fmul_rn(m, cv[c]));
      key = last_key[sb];
    }
    ck = key;
    for (int c = 0; c < NC; ++c) carry[c] = cv[c];
  }
  __syncthreads();
  const size_t base = (size_t)s * n + (size_t)b * T;
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    const float m = ks[base + i] == ck ? 1.0f : 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float* o = ch.out[c] + (base + i) * ch.stride;
      *o = __fadd_rn(*o, __fmul_rn(m, carry[c]));
    }
  }
}

template <int NC>
int launch_segsum(const int* ks, Chans<NC> ch, int S, int N, int T, int* last_key,
                  float* last_val, cudaStream_t st) {
  if (T <= 0 || T > kThreads * kMaxPerThread || N % T != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)T * (1 + NC) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      seg_block_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(N / T, S);
  seg_block_kernel<NC><<<grid, kThreads, smem, st>>>(ks, ch, N, T, last_key, last_val);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  seg_carry_kernel<NC><<<grid, 256, 0, st>>>(ks, ch, N, T, last_key, last_val);
  return (int)cudaGetLastError();
}

}  // namespace

// K7.  ks (S, N) i32 sorted per row; xs, ys, zs (S, N) f32; N % T == 0,
// T % 128 == 0, T <= 8192.  Outputs ox, oy, oz (S, N) f32; scratch
// last_key (S, N/T) i32 and last_val (S, N/T, 3) f32.
extern "C" int motl_segment_totals(const int* ks, const float* xs,
                                   const float* ys, const float* zs, int S,
                                   int N, int T, float* ox, float* oy,
                                   float* oz, int* last_key, float* last_val,
                                   void* stream) {
  Chans<3> ch{{xs, ys, zs}, {ox, oy, oz}, 1};
  return launch_segsum<3>(ks, ch, S, N, T, last_key, last_val, (cudaStream_t)stream);
}

// K9.  ks (S, N) i32 sorted per row; vals (S, N, 4) f32; N % T == 0,
// T <= 8192.  Output out (S, N, 4) f32; scratch last_key (S, N/T) i32 and
// last_val (S, N/T, 4) f32.
extern "C" int motl_segment_totals_rows(const int* ks, const float* vals, int S, int N, int T,
                                        float* out, int* last_key, float* last_val,
                                        void* stream) {
  Chans<4> ch{{vals, vals + 1, vals + 2, vals + 3}, {out, out + 1, out + 2, out + 3}, 4};
  return launch_segsum<4>(ks, ch, S, N, T, last_key, last_val, (cudaStream_t)stream);
}
