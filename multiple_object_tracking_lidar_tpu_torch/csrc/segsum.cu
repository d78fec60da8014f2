// K7 and K9: segmented prefix totals over key-sorted rows.
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
// What bounds it on the H100: bytes (one read of each key and value, one
// write of each output) and, past them, latency: 13 dependent passes over a
// block's 8,192 rows on one SM, and a chain of N / T blocks per frame.  On
// the H100 the ten passes through shared memory take about 18 of the ~31 us
// a block needs, and the random reads through the permutation 12-18 us more
// (PERF.md, K7's row).  Design, one launch per call:
//  * each thread holds 8 consecutive rows in registers; the passes at
//    sh = 1, 2, 4 run inside the thread on its rows and the 7 before them
//    (read from shared memory once, recomputed redundantly), so they need
//    no barrier; a pass at sh = 8m moves values by m threads: by warp
//    shuffle from the lanes >= m, through a double-buffered shared array
//    from the rest (one __syncthreads per pass, 10 at T = 8,192 where the
//    two-launch design before it took 26); shared memory is read and
//    written 16 bytes at a time;
//  * the carry chain runs in the same launch as a chained scan with
//    look-back: blocks take logical ids from an atomic ticket (so every
//    block before b is resident before b waits on it); each block but a
//    frame's last publishes its (last key, last local prefix) as soon as its
//    passes end; block b waits for those of blocks 0 .. b-1 and walks the
//    recurrence cv <- last_j + [k_j == key] * cv from block 0 itself --
//    today's ops in today's order -- then folds; no block waits on another's
//    fold, so the chain costs one round trip, not b;
//  * the values are read through the sort's permutation (vals[perm[i]]),
//    so the caller gathers nothing;
//  * the ticket, the done count and the flags live in a small scratch the
//    wrapper zeroes once per (device, stream); the last block out clears
//    them, so the next launch on the stream finds them zero.
// Every f32 op is __fmul_rn / __fadd_rn.
//
// K9 replaces the Pallas kernel multiple_object_tracking_lidar_tpu/ops/
// voxel_pallas.py::segment_totals_pallas (body _segsum_kernel), K7's
// predecessor: the same tree over flat blocks of T = min(2048, N) rows
// (any T), with the 4 channels of one (N, 4) array.  It keeps the design
// K7 had before: one CTA per block with the passes in shared memory
// (40 KB at T = 2,048), then the carry chain as a second launch.

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

constexpr int kRows = 8;   // K7: consecutive rows per thread
constexpr int kHalo = 7;   // rows before a thread's first that sh = 1, 2, 4 reach
constexpr int kMaxRowsK7 = kRows * kThreads;

// Raises a kernel's dynamic shared-memory limit once per process and device,
// not on every call.
template <class F>
cudaError_t allow_smem(F* kern, size_t smem, size_t (&set)[16]) {
  int d = 0;
  cudaError_t err = cudaGetDevice(&d);
  if (err != cudaSuccess) return err;
  if (d < 16 && set[d] >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && d < 16) set[d] = smem;
  return err;
}

// Thread o's 8 rows at p + 8 o, as two 16-byte accesses.
__device__ __forceinline__ void load8(const float* p, int o, float (&v)[kRows]) {
  const float4 a = reinterpret_cast<const float4*>(p + o * kRows)[0];
  const float4 b = reinterpret_cast<const float4*>(p + o * kRows)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w; v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void store8(float* p, int o, const float (&v)[kRows]) {
  reinterpret_cast<float4*>(p + o * kRows)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p + o * kRows)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void load8(const int* p, int o, int (&v)[kRows]) {
  const int4 a = reinterpret_cast<const int4*>(p + o * kRows)[0];
  const int4 b = reinterpret_cast<const int4*>(p + o * kRows)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w; v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// K7.  Channel c of sorted row r of frame s is vc[(s * n + p) * vstride],
// p = perm[s * n + r] (a row index within the frame), or p = r without a
// permutation.  chain: [ticket, done, flag[cap], (key, v0, v1, v2)[cap]].
__global__ void __launch_bounds__(kThreads)
seg_chain_kernel(const int* __restrict__ ks, const float* __restrict__ v0,
                 const float* __restrict__ v1, const float* __restrict__ v2, int vstride,
                 const int64_t* __restrict__ perm, int n, int T, int nb,
                 float* __restrict__ o0, float* __restrict__ o1, float* __restrict__ o2,
                 unsigned* chain, int cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* K = reinterpret_cast<int*>(smem);            // [T] keys
  float* buf0 = reinterpret_cast<float*>(K + T);    // [3][T]
  float* buf1 = buf0 + 3 * T;                       // [3][T]
  __shared__ unsigned s_ticket;
  __shared__ int s_ck;
  __shared__ float s_carry[3];
  if (threadIdx.x == 0) s_ticket = atomicAdd(&chain[0], 1u);
  __syncthreads();
  const unsigned tk = s_ticket;
  const int s = (int)(tk / (unsigned)nb), b = (int)(tk % (unsigned)nb);
  const size_t frame = (size_t)s * n;
  const size_t base = frame + (size_t)b * T;
  const int nt = T / kRows;  // threads that hold rows
  const int t = threadIdx.x, lane = t & 31;
  const bool act = t < nt;
  const float* vin[3] = {v0, v1, v2};
  unsigned* flag = chain + 2;
  unsigned* pub = chain + 2 + cap;
  // the block's rows, read coalesced (row i by thread i mod blockDim) into
  // shared memory, then 8 consecutive rows per thread into registers
  for (int i = t; i < T; i += blockDim.x) {
    const size_t p = frame + (perm ? (size_t)perm[base + i] : (size_t)(b * T + i));
    K[i] = ks[base + i];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) buf0[ch * T + i] = vin[ch][p * vstride];
  }
  __syncthreads();
  float c[3][kRows];
  int k[kRows];
  if (act) {
    load8(K, t, k);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) load8(buf0 + ch * T, t, c[ch]);
  }

  // sh = 1, 2, 4 on the thread's rows and the 7 before them (the previous
  // thread's last 7, cyclic): position q holds row (8 t - 7 + q) mod T;
  // sh = 1 updates q >= 1, sh = 2 q >= 3, sh = 4 q >= 7 -- each from values
  // the pass before made right
  if (act) {
    const int prev = (t == 0 ? nt : t) - 1;
    int hk[kHalo + kRows];
    {
      int pk[kRows];
      load8(K, prev, pk);
#pragma unroll
      for (int q = 0; q < kHalo + kRows; ++q) hk[q] = q < kHalo ? pk[q + 1] : k[q - kHalo];
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float h[kHalo + kRows], pv[kRows];
      load8(buf0 + ch * T, prev, pv);
#pragma unroll
      for (int q = 0; q < kHalo + kRows; ++q) h[q] = q < kHalo ? pv[q + 1] : c[ch][q - kHalo];
#pragma unroll
      for (int sh = 1; sh <= 4; sh <<= 1) {
#pragma unroll
        for (int q = kHalo + kRows - 1; q >= 2 * sh - 1; --q) {  // descending: reads the old h[q - sh]
          const int row = (t * kRows - kHalo + q + T) % T;
          const float same = (hk[q - sh] == hk[q] && row >= sh) ? 1.0f : 0.0f;
          h[q] = __fadd_rn(h[q], __fmul_rn(h[q - sh], same));
        }
      }
#pragma unroll
      for (int e = 0; e < kRows; ++e) c[ch][e] = h[kHalo + e];
    }
  }

  // sh = 8 m: row i reads row i - 8m, the same slot of thread (t - m) mod nt
  int pass = 0;
  for (int sh = kRows; sh < T; sh <<= 1, ++pass) {
    const int m = sh / kRows;
    float* W = (pass & 1) ? buf0 : buf1;  // buf0's last readers passed the barrier before
    const bool from_smem = m >= 32 || lane < m;
    if (act && (m >= 32 || lane >= 32 - m || t >= nt - m)) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) store8(W + ch * T, t, c[ch]);
    }
    __syncthreads();
    const int src = t - m < 0 ? t - m + nt : t - m;
    float same[kRows];
    if (act) {
      int sk[kRows];
      load8(K, src, sk);
#pragma unroll
      for (int e = 0; e < kRows; ++e)
        same[e] = (sk[e] == k[e] && t * kRows + e >= sh) ? 1.0f : 0.0f;
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float v[kRows];
      if (m < 32) {  // uniform over the block: shuffles only where a lane can source one
#pragma unroll
        for (int e = 0; e < kRows; ++e) v[e] = __shfl_up_sync(0xffffffffu, c[ch][e], m);
      }
      if (act) {
        if (from_smem) load8(W + ch * T, src, v);
#pragma unroll
        for (int e = 0; e < kRows; ++e) c[ch][e] = __fadd_rn(c[ch][e], __fmul_rn(v[e], same[e]));
      }
    }
  }

  // the carry: every block but the frame's last publishes its own (last
  // key, last local prefix) at once; block b waits for those of blocks
  // 0 .. b-1 (one thread each) and walks the recurrence from block 0
  if (t == nt - 1 && b < nb - 1) {
    volatile unsigned* mine = pub + 4 * (size_t)tk;
    mine[0] = (unsigned)k[kRows - 1];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) mine[1 + ch] = __float_as_uint(c[ch][kRows - 1]);
    __threadfence();
    atomicExch(&flag[tk], 1u);
  }
  if (b > 0) {
    int* lk = reinterpret_cast<int*>(buf0);  // the summaries of blocks 0 .. b-1
    float* lv = buf0 + b;
    __syncthreads();                         // every reader of buf0 and buf1 is done
    for (int j = t; j < b; j += blockDim.x) {
      const unsigned q = tk - b + j;
      while (*(volatile unsigned*)&flag[q] == 0u) {
      }
      __threadfence();
      const volatile unsigned* pv = pub + 4 * (size_t)q;
      lk[j] = (int)pv[0];
      for (int ch = 0; ch < 3; ++ch) lv[3 * j + ch] = __uint_as_float(pv[1 + ch]);
    }
    __syncthreads();
    if (t == 0) {
      int key = lk[0];
      float cv[3] = {lv[0], lv[1], lv[2]};
      for (int j = 1; j < b; ++j) {  // block j's last output
        const float mk = lk[j] == key ? 1.0f : 0.0f;
        for (int ch = 0; ch < 3; ++ch) cv[ch] = __fadd_rn(lv[3 * j + ch], __fmul_rn(mk, cv[ch]));
        key = lk[j];
      }
      s_ck = key;
      for (int ch = 0; ch < 3; ++ch) s_carry[ch] = cv[ch];
    }
  }
  __syncthreads();  // also: every reader of buf1 is done
  if (act) {
    const int ck = b > 0 ? s_ck : 0;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      if (b > 0) {
        const float cv = s_carry[ch];
#pragma unroll
        for (int e = 0; e < kRows; ++e) {
          const float mk = k[e] == ck ? 1.0f : 0.0f;
          c[ch][e] = __fadd_rn(c[ch][e], __fmul_rn(mk, cv));
        }
      }
      store8(buf1 + ch * T, t, c[ch]);
    }
  }
  __syncthreads();
  {  // the outputs, written coalesced, 16 bytes a thread
    float* out[3] = {o0, o1, o2};
    for (int q = t; q < 3 * (T / 4); q += blockDim.x) {
      const int ch = q / (T / 4), r = 4 * (q - ch * (T / 4));
      *reinterpret_cast<float4*>(out[ch] + base + r) =
          *reinterpret_cast<const float4*>(buf1 + ch * T + r);
    }
  }
  // the last block out clears the flags, the ticket and the done count for
  // the next launch on this stream: every reader of a flag is done by now
  if (t == 0) {
    __threadfence();
    if (atomicAdd(&chain[1], 1u) == gridDim.x - 1) {
      for (unsigned q = 0; q < gridDim.x; ++q) flag[q] = 0u;
      chain[0] = 0u;
      chain[1] = 0u;
      __threadfence();
    }
  }
}

size_t g_k7_smem[16], g_k9_block_smem[16];

// K9: the passes of each block in shared memory, then the carry chain as a
// second launch.
int launch_rows(const int* ks, Chans<4> ch, int S, int N, int T, int* last_key,
                float* last_val, cudaStream_t st) {
  if (T <= 0 || T > kThreads * kMaxPerThread || N % T != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)T * 5 * sizeof(float);
  cudaError_t err = allow_smem(seg_block_kernel<4>, smem, g_k9_block_smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(N / T, S);
  seg_block_kernel<4><<<grid, kThreads, smem, st>>>(ks, ch, N, T, last_key, last_val);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  seg_carry_kernel<4><<<grid, 256, 0, st>>>(ks, ch, N, T, last_key, last_val);
  return (int)cudaGetLastError();
}

}  // namespace

// K7.  ks (S, N) i32 sorted per row; channel c of row r of frame s is
// vc[(s * N + p) * vstride] with p = perm[s * N + r] (i64, a row of the
// frame) or p = r when perm is null; N % T == 0, T % 128 == 0, T <= 8192.
// Outputs ox, oy, oz (S, N) f32 (16-byte aligned).  chain: u32 scratch of
// 2 + 5 * cap words, zero before the first launch on a stream and left zero
// by every launch; cap >= S * N / T.
extern "C" int motl_segment_totals(const int* ks, const float* xs, const float* ys,
                                   const float* zs, int vstride, const int64_t* perm, int S,
                                   int N, int T, float* ox, float* oy, float* oz,
                                   unsigned* chain, int cap, void* stream) {
  if (S < 1 || T <= 0 || T % 128 != 0 || T > kMaxRowsK7 || N % T != 0 || vstride < 1 ||
      (long long)S * (N / T) > cap)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)T * 7 * sizeof(float);
  cudaError_t err = allow_smem(seg_chain_kernel, smem, g_k7_smem);
  if (err != cudaSuccess) return (int)err;
  const int nb = N / T;
  const int threads = ((T / kRows) + 31) / 32 * 32;
  seg_chain_kernel<<<S * nb, threads, smem, (cudaStream_t)stream>>>(
      ks, xs, ys, zs, vstride, perm, N, T, nb, ox, oy, oz, chain, cap);
  return (int)cudaGetLastError();
}

// K9.  ks (S, N) i32 sorted per row; vals (S, N, 4) f32; N % T == 0,
// T <= 8192.  Output out (S, N, 4) f32; scratch last_key (S, N/T) i32 and
// last_val (S, N/T, 4) f32.
extern "C" int motl_segment_totals_rows(const int* ks, const float* vals, int S, int N, int T,
                                        float* out, int* last_key, float* last_val,
                                        void* stream) {
  Chans<4> ch{{vals, vals + 1, vals + 2, vals + 3}, {out, out + 1, out + 2, out + 3}, 4};
  return launch_rows(ks, ch, S, N, T, last_key, last_val, (cudaStream_t)stream);
}
