// K8: all-pairs fixed-radius connected components over the capped point list.
//
// Replaces the Pallas kernel multiple_object_tracking_lidar_tpu/ops/
// cluster_pallas.py::connected_components_pallas (body _cc_kernel), the
// cluster_backend="pallas" CC.  Labels are the minimum point index of each
// component after the kernel's Jacobi min-label sweeps (M for invalid rows),
// with the same early exit and the same sweep cap, so a cut-short run gives
// the TPU kernel's labels too.
//
// The float ops are the interpret-mode kernel's, found on XLA's CPU code:
//  * centre c = colsum(pts * mask) / max(count, 1), where the column sum is
//    XLA's tree-rewritten reduction: windows of 32 rows summed in order from
//    +0.0f, the window sums again in windows of 32 while more than 32
//    remain, then the last <= 32 in order;
//  * p = (pts - c) * mask, sq = fma(p2, p2, fma(p1, p1, p0 * p0)) (XLA
//    contracts the row sum into FMAs), 3e38 on invalid rows;
//  * gram_ij = fma(p2_i, p2_j, fma(p1_i, p1_j, p0_i * p0_j)) (the f32
//    HIGHEST dot_general on the CPU), d2 = (sq_i + sq_j) - 2 * gram_ij, and
//    the pair is adjacent when d2 <= tol2, tol2 = f32(tol * tol in f64).
// Every op is an explicit __fmul_rn / __fadd_rn / __fmaf_rn / __fdiv_rn.
//
// Three kernels:
//  1. prep: one CTA per frame -- count, the tree column sum, p and sq;
//  2. adjacency: one thread per (row i, 32-column word w, frame): the 32
//     d2 tests of the word, stored as bits[s][w][i] (row fastest, so the
//     sweeps read it coalesced);
//  3. sweeps: one CTA per frame; labels double-buffered in shared memory;
//     each sweep every row takes min(old, min over set bits of old[j]) --
//     Jacobi, reading only the previous sweep -- and __syncthreads_or ends
//     the loop when nothing changed, or after n_sweeps sweeps.
// The jnp backend (ops/cluster.py) runs kernels 1 and 2 alone and its own
// sweeps with pointer jumps, so both backends test the same d2 bits.
//
// What bounds it on the H100: the sweeps are serial, one CTA per frame, and
// each reads the whole adjacency: M * M / 8 bytes (128 KB at M = 1,024, the
// headline's m_max_dynamic; 512 KB at M = 2,048, the default).  The TPU
// kernel recomputes the (B, M) gram every sweep on the MXU; here the
// adjacency does not change between sweeps, so it is computed once, by
// M * M / 32 threads in parallel, and the sweeps stream it from L2 (it fits
// the 50 MB L2 many times over) in coalesced words, skipping unset bits
// with __ffs.  A sweep costs ~M / 1,024 rows per thread times M / 32 words.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWindow = 32;  // XLA's tree-reduction window on the CPU

__global__ void __launch_bounds__(kThreads) cc_prep_kernel(const float* __restrict__ pts,
                                                           const uint8_t* __restrict__ mask,
                                                           int M, float* __restrict__ P,
                                                           float* __restrict__ SQ) {
  extern __shared__ float part[];  // two buffers of 3 * ceil(M / 32) floats
  __shared__ float s_c[3];
  __shared__ int s_cnt;
  const int s = blockIdx.x;
  const float* X = pts + (size_t)s * M * 3;
  const uint8_t* MK = mask + (size_t)s * M;
  const int nb0 = (M + kWindow - 1) / kWindow;
  float* buf[2] = {part, part + 3 * nb0};
  if (threadIdx.x == 0) s_cnt = 0;
  __syncthreads();
  int local = 0;
  for (int i = threadIdx.x; i < M; i += blockDim.x) local += MK[i] != 0;
  atomicAdd(&s_cnt, local);
  // level 0: windows of 32 rows of pts * mask, each summed in order from +0
  for (int t = threadIdx.x; t < 3 * nb0; t += blockDim.x) {
    const int k = t / nb0, b = t - k * nb0;
    float a = 0.0f;
    for (int i = b * kWindow; i < min(M, (b + 1) * kWindow); ++i)
      a = __fadd_rn(a, __fmul_rn(X[3 * i + k], MK[i] ? 1.0f : 0.0f));
    buf[0][t] = a;
  }
  __syncthreads();
  int n = nb0, cur = 0;
  while (n > kWindow) {  // further levels while more than 32 partials remain
    const int nb = (n + kWindow - 1) / kWindow;
    for (int t = threadIdx.x; t < 3 * nb; t += blockDim.x) {
      const int k = t / nb, b = t - k * nb;
      float a = 0.0f;
      for (int i = b * kWindow; i < min(n, (b + 1) * kWindow); ++i)
        a = __fadd_rn(a, buf[cur][k * n + i]);
      buf[1 - cur][t] = a;
    }
    __syncthreads();
    n = nb;
    cur = 1 - cur;
  }
  if (threadIdx.x < 3) {
    float a = 0.0f;
    for (int i = 0; i < n; ++i) a = __fadd_rn(a, buf[cur][threadIdx.x * n + i]);
    s_c[threadIdx.x] = __fdiv_rn(a, fmaxf((float)s_cnt, 1.0f));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    const float mf = MK[i] ? 1.0f : 0.0f;
    const float p0 = __fmul_rn(__fsub_rn(X[3 * i], s_c[0]), mf);
    const float p1 = __fmul_rn(__fsub_rn(X[3 * i + 1], s_c[1]), mf);
    const float p2 = __fmul_rn(__fsub_rn(X[3 * i + 2], s_c[2]), mf);
    float* pr = P + ((size_t)s * M + i) * 3;
    pr[0] = p0;
    pr[1] = p1;
    pr[2] = p2;
    const float sq = __fmaf_rn(p2, p2, __fmaf_rn(p1, p1, __fmul_rn(p0, p0)));
    SQ[(size_t)s * M + i] = MK[i] ? sq : 3e38f;
  }
}

__global__ void cc_adjacency_kernel(const float* __restrict__ P, const float* __restrict__ SQ,
                                    int M, float tol2, unsigned* __restrict__ bits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int w = blockIdx.y, s = blockIdx.z;
  const int W = gridDim.y;
  if (i >= M) return;
  const float* Pf = P + (size_t)s * M * 3;
  const float* SQf = SQ + (size_t)s * M;
  const float x = Pf[3 * i], y = Pf[3 * i + 1], z = Pf[3 * i + 2], sqi = SQf[i];
  unsigned word = 0u;
  for (int b = 0; b < 32; ++b) {
    const int j = w * 32 + b;
    if (j >= M) break;
    const float g = __fmaf_rn(z, Pf[3 * j + 2], __fmaf_rn(y, Pf[3 * j + 1], __fmul_rn(x, Pf[3 * j])));
    const float d2 = __fsub_rn(__fadd_rn(sqi, SQf[j]), __fmul_rn(2.0f, g));
    if (d2 <= tol2) word |= 1u << b;
  }
  bits[((size_t)s * W + w) * M + i] = word;
}

__global__ void __launch_bounds__(kThreads) cc_sweep_kernel(const unsigned* __restrict__ bits,
                                                            const uint8_t* __restrict__ mask,
                                                            int M, int n_sweeps,
                                                            int* __restrict__ labels,
                                                            int* __restrict__ sweeps) {
  extern __shared__ int lab[];  // two buffers of M labels
  const int s = blockIdx.x;
  const int W = (M + 31) / 32;
  const unsigned* B = bits + (size_t)s * W * M;
  const uint8_t* MK = mask + (size_t)s * M;
  int* cur = lab;
  int* nxt = lab + M;
  for (int i = threadIdx.x; i < M; i += blockDim.x) cur[i] = MK[i] ? i : M;
  __syncthreads();
  int it = 0;
  while (it < n_sweeps) {
    int changed = 0;
    for (int i = threadIdx.x; i < M; i += blockDim.x) {
      int nmin = M;
      for (int w = 0; w < W; ++w) {
        unsigned word = B[(size_t)w * M + i];
        while (word) {
          const int b = __ffs(word) - 1;
          word &= word - 1u;
          nmin = min(nmin, cur[w * 32 + b]);
        }
      }
      const int nv = min(cur[i], nmin);
      nxt[i] = nv;
      changed |= nv != cur[i];
    }
    ++it;
    const int any = __syncthreads_or(changed);
    int* t = cur;
    cur = nxt;
    nxt = t;
    if (!any) break;
  }
  for (int i = threadIdx.x; i < M; i += blockDim.x) labels[(size_t)s * M + i] = cur[i];
  if (threadIdx.x == 0) sweeps[s] = it;
}

int launch_adjacency(const float* pts, const uint8_t* mask, int S, int M, float tol2, float* P,
                     float* SQ, unsigned* bits, cudaStream_t st) {
  const int nb0 = (M + kWindow - 1) / kWindow;
  const size_t smem = (size_t)2 * 3 * nb0 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      cc_prep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cc_prep_kernel<<<S, kThreads, smem, st>>>(pts, mask, M, P, SQ);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int W = (M + 31) / 32;
  cc_adjacency_kernel<<<dim3((M + 127) / 128, W, S), 128, 0, st>>>(P, SQ, M, tol2, bits);
  return (int)cudaGetLastError();
}

}  // namespace

// pts (S, M, 3) f32, mask (S, M) u8 -> bits (S, ceil(M / 32), M) u32, bit b
// of bits[s][w][i] set when rows i and 32 * w + b are adjacent.  Scratch
// P (S, M, 3) f32, SQ (S, M) f32.
extern "C" int motl_cc_adjacency(const float* pts, const uint8_t* mask, int S, int M,
                                 float tol2, float* P, float* SQ, unsigned* bits,
                                 void* stream) {
  if (S < 1 || M < 1) return (int)cudaErrorInvalidValue;
  return launch_adjacency(pts, mask, S, M, tol2, P, SQ, bits, (cudaStream_t)stream);
}

// The whole CC: the adjacency as above, then up to n_sweeps Jacobi sweeps.
// labels (S, M) i32; sweeps (S,) i32 the sweeps run (the last one changed
// nothing unless the cap cut the loop).
extern "C" int motl_cc_labels(const float* pts, const uint8_t* mask, int S, int M, float tol2,
                              int n_sweeps, float* P, float* SQ, unsigned* bits, int* labels,
                              int* sweeps, void* stream) {
  if (S < 1 || M < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int e = launch_adjacency(pts, mask, S, M, tol2, P, SQ, bits, st);
  if (e != 0) return e;
  const size_t smem = (size_t)2 * M * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      cc_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cc_sweep_kernel<<<S, kThreads, smem, st>>>(bits, mask, M, n_sweeps, labels, sweeps);
  return (int)cudaGetLastError();
}
