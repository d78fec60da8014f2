// K7 and K9: segmented prefix totals over key-sorted rows.
//
// K7 replaces the Pallas kernel multiple_object_tracking_lidar_tpu/ops/
// voxel_pallas.py::segment_totals_raster (body _segsum_raster_kernel), the
// segment sums of voxel_mode="runs".  K9 replaces its predecessor,
// voxel_pallas.py::segment_totals_pallas (body _segsum_kernel).  Rows
// arrive sorted by cell key; row i of the output holds the sum of its run's
// rows up to and including i, so the last row of each run holds the run's
// total.
//
// Both compute their Pallas kernel's exact float tree, so the result is
// bit-identical:
//  * per block of T flat rows -- K7: T = rb * 128 (rb = min(64, N / 128));
//    K9: T = min(2048, N), any T -- passes at sh = 1, 2, ..., < T of
//    c_i <- c_i + c_{(i-sh) mod T} * same_i  with
//    same_i = [k_{(i-sh) mod T} == k_i and i >= sh] as 0.0f / 1.0f: the
//    TPU's rolls are cyclic inside the block, and the multiply-by-0/1 form
//    (not a branch) moves signed zeros, inf and NaN as the TPU does;
//  * for every block b > 0: out = c + [k == carry_key] * carry, over the
//    whole block, where carry_key and carry are block b-1's last key and
//    last OUTPUT (its own fold included) (voxel_pallas.py:52-63, :295-312).
//
// What bounds them on the H100: bytes (one read of each key and value, one
// write of each output) and, past them, latency: log2(T) dependent passes
// over a block on one SM, and a chain of N / T blocks per frame.  Design,
// one kernel body (seg_chain_kernel), one launch per call; the two
// instantiations differ only in how a block's rows are read and written
// (the layouts below) and in the number of channels:
//  * each thread holds 8 consecutive rows in registers; the passes at
//    sh = 1, 2, 4 run inside the thread on its rows and the 7 before them
//    (read from shared memory once, recomputed redundantly), so they need
//    no barrier; a pass at sh = 8m moves values by m threads: by warp
//    shuffle from the lanes >= m, through a double-buffered shared array
//    from the rest (one __syncthreads per pass); shared memory is read and
//    written 16 bytes at a time;
//  * the carry chain runs in the same launch as a chained scan with
//    look-back: blocks take logical ids from an atomic ticket (so every
//    block before b is resident before b waits on it); each block but a
//    frame's last publishes its (last key, last local prefix) as soon as its
//    passes end; block b waits for those of blocks 0 .. b-1 and walks the
//    recurrence cv <- last_j + [k_j == key] * cv from block 0 itself --
//    the Pallas kernel's ops in its order -- then folds; no block waits on
//    another's fold, so the chain costs one round trip, not b;
//  * the ticket, the done count and the flags live in a small scratch the
//    wrapper zeroes once per (device, stream) and shares between K7 and K9;
//    the last block out clears them, so the next launch on the stream finds
//    them zero.
// K7 (Planar3): 1,024 threads, T <= 8,192; the three channels read through
// the sort's permutation (vals[perm[i]]), so the caller gathers nothing.
// On the H100 the ten passes through shared memory take about 18 of the
// ~31 us a block needs, and the random reads through the permutation 12-18
// us more (PERF.md, K7's row).
// K9 (Rows4): one (S, N, 4) array, each row one 16-byte load and one
// 16-byte store, a thread's 8 loads in flight together; 256 threads for
// T = 2,048 (8 passes through shared memory, 73.7 KB of it; two blocks per
// SM, by registers).  Below 2,048 rows a frame is one block of T = N rows,
// any N: shared memory is laid out at a pitch of T rounded up to 8 (the
// last thread holds T mod 8 rows), and the rows that the cyclic roll wraps
// onto are read at their true index.
// Every f32 op is __fmul_rn / __fadd_rn.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;   // consecutive rows per thread
constexpr int kHalo = 7;   // rows before a thread's first that sh = 1, 2, 4 reach
constexpr int kRecordWords = 5;  // a published block: key + up to 4 channels

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

// The block row that position q of thread t's window holds (q < 7: the
// rows before its first, cyclic: thread 0's wrap to the block's end, which
// a block of fewer than 7 rows wraps more than once).
__device__ __forceinline__ int window_row(int t, int q, int T) {
  const int r = t * kRows - kHalo + q;
  return r >= 0 ? r : (r % T + T) % T;
}

// K7's rows: channel ch of sorted row r of frame s is
// v[ch][(s * n + p) * vstride], p = perm[s * n + r] (a row of the frame),
// or p = r without a permutation; outputs three (S, N) planes.
struct Planar3 {
  static constexpr int NC = 3;
  static constexpr int kThreads = 1024;
  static constexpr int kMinBlocks = 1;
  static constexpr bool kRagged = false;  // T % 128 == 0
  const float* v0;
  const float* v1;
  const float* v2;
  int vstride;
  const int64_t* perm;
  float* o0;
  float* o1;
  float* o2;

  // the block's rows, coalesced (row i by thread i mod blockDim), into
  // shared memory: keys K[i], channel ch at buf[ch * Tp + i]
  __device__ void load(const int* __restrict__ ks, int* K, float* buf, size_t frame,
                       size_t base, int b, int T, int Tp) const {
    const float* vin[3] = {v0, v1, v2};
    for (int i = threadIdx.x; i < T; i += blockDim.x) {
      const size_t p = frame + (perm ? (size_t)perm[base + i] : (size_t)(b * T + i));
      K[i] = ks[base + i];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) buf[ch * Tp + i] = vin[ch][p * vstride];
    }
  }
  // the outputs from shared memory, coalesced, 16 bytes a thread
  __device__ void store(const float* buf, size_t base, int T, int Tp) const {
    float* out[3] = {o0, o1, o2};
    for (int q = threadIdx.x; q < 3 * (T / 4); q += blockDim.x) {
      const int ch = q / (T / 4), r = 4 * (q - ch * (T / 4));
      *reinterpret_cast<float4*>(out[ch] + base + r) =
          *reinterpret_cast<const float4*>(buf + ch * Tp + r);
    }
  }
};

// K9's rows: row r of frame s is the 4 floats at v + 4 (s * n + r), read
// as one 16-byte load where v is 16-byte aligned; the output likewise.
struct Rows4 {
  static constexpr int NC = 4;
  static constexpr int kThreads = 256;
  static constexpr int kMinBlocks = 2;   // up to 128 registers: no spills
  static constexpr bool kRagged = true;   // T = N < 2,048 may be any size
  const float* v;
  float* o;  // 16-byte aligned

  // row i by thread i mod blockDim, all 8 of a thread's loads in flight
  // (blockDim >= Tp / 8); rows T .. Tp - 1 (the last thread's missing
  // rows) are zero: read by nothing, but defined
  __device__ void load(const int* __restrict__ ks, int* K, float* buf, size_t frame,
                       size_t base, int b, int T, int Tp) const {
    const bool vec = ((uintptr_t)v & 15) == 0;
    float4 a[kRows];
    int key[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int i = threadIdx.x + j * blockDim.x;
      a[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      key[j] = 0;
      if (i < T) {
        const float* p = v + 4 * (base + i);
        key[j] = ks[base + i];
        a[j] = vec ? *reinterpret_cast<const float4*>(p) : make_float4(p[0], p[1], p[2], p[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int i = threadIdx.x + j * blockDim.x;
      if (i < Tp) {
        K[i] = key[j];
        buf[i] = a[j].x;
        buf[Tp + i] = a[j].y;
        buf[2 * Tp + i] = a[j].z;
        buf[3 * Tp + i] = a[j].w;
      }
    }
  }
  __device__ void store(const float* buf, size_t base, int T, int Tp) const {
    for (int i = threadIdx.x; i < T; i += blockDim.x)
      reinterpret_cast<float4*>(o)[base + i] =
          make_float4(buf[i], buf[Tp + i], buf[2 * Tp + i], buf[3 * Tp + i]);
  }
};

// One block of T rows of one frame per CTA, in ticket order.  Shared
// memory: keys [Tp], then two buffers of [NC][Tp] floats, Tp = T rounded up
// to 8.  chain: [ticket, done, flag[cap], record[kRecordWords * cap]], a
// record (last key, last local prefix of each channel).
template <class L>
__global__ void __launch_bounds__(L::kThreads, L::kMinBlocks)
seg_chain_kernel(const int* __restrict__ ks, L lay, int n, int T, int nb, unsigned* chain,
                 int cap) {
  constexpr int NC = L::NC;
  const int Tp = (T + kRows - 1) / kRows * kRows;
  extern __shared__ __align__(16) unsigned char smem[];
  int* K = reinterpret_cast<int*>(smem);            // [Tp] keys
  float* buf0 = reinterpret_cast<float*>(K + Tp);   // [NC][Tp]
  float* buf1 = buf0 + NC * Tp;                     // [NC][Tp]
  __shared__ unsigned s_ticket;
  __shared__ int s_ck;
  __shared__ float s_carry[NC];
  if (threadIdx.x == 0) s_ticket = atomicAdd(&chain[0], 1u);
  __syncthreads();
  const unsigned tk = s_ticket;
  const int s = (int)(tk / (unsigned)nb), b = (int)(tk % (unsigned)nb);
  const size_t frame = (size_t)s * n;
  const size_t base = frame + (size_t)b * T;
  const int nt = Tp / kRows;  // threads that hold rows (the last T - 8 (nt - 1) of them)
  const int t = threadIdx.x, lane = t & 31;
  const bool act = t < nt;
  unsigned* flag = chain + 2;
  unsigned* pub = chain + 2 + cap;
  lay.load(ks, K, buf0, frame, base, b, T, Tp);
  __syncthreads();
  float c[NC][kRows];
  int k[kRows];
  if (act) {
    load8(K, t, k);
#pragma unroll
    for (int ch = 0; ch < NC; ++ch) load8(buf0 + ch * Tp, t, c[ch]);
  }

  // sh = 1, 2, 4 on the thread's rows and the 7 before them (the previous
  // thread's last 7, cyclic): position q holds row window_row(t, q);
  // sh = 1 updates q >= 1, sh = 2 q >= 3, sh = 4 q >= 7 -- each from values
  // the pass before made right.  [row >= sh] holds in every thread but 0,
  // whose own rows are q - 7 and whose wrapped rows' tests are bit
  // 7 p + q of wrapped (sh = 2^p).  Thread 0 of a block whose T is not a
  // multiple of 8 reads its window's wrapped rows one by one.
  if (act) {
    const bool whole = !L::kRagged || t > 0 || T % kRows == 0;
    const int prev = (t == 0 ? nt : t) - 1;
    unsigned wrapped = 0u;
#pragma unroll
    for (int q = 0; q < kHalo; ++q) {
      const int row = window_row(0, q, T);
#pragma unroll
      for (int p = 0; p < 3; ++p) wrapped |= (row >= (1 << p) ? 1u : 0u) << (kHalo * p + q);
    }
    const bool later = t > 0;
    int hk[kHalo + kRows];
    if (whole) {
      int pk[kRows];
      load8(K, prev, pk);
#pragma unroll
      for (int q = 0; q < kHalo; ++q) hk[q] = pk[q + 1];
    } else {
#pragma unroll
      for (int q = 0; q < kHalo; ++q) hk[q] = K[window_row(t, q, T)];
    }
#pragma unroll
    for (int q = kHalo; q < kHalo + kRows; ++q) hk[q] = k[q - kHalo];
#pragma unroll
    for (int ch = 0; ch < NC; ++ch) {
      float h[kHalo + kRows];
      if (whole) {
        float pv[kRows];
        load8(buf0 + ch * Tp, prev, pv);
#pragma unroll
        for (int q = 0; q < kHalo; ++q) h[q] = pv[q + 1];
      } else {
#pragma unroll
        for (int q = 0; q < kHalo; ++q) h[q] = buf0[ch * Tp + window_row(t, q, T)];
      }
#pragma unroll
      for (int q = kHalo; q < kHalo + kRows; ++q) h[q] = c[ch][q - kHalo];
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const int sh = 1 << p;
        if (!L::kRagged || sh < T) {
#pragma unroll
          for (int q = kHalo + kRows - 1; q >= 2 * sh - 1; --q) {  // descending: reads the old h[q - sh]
            const bool ge = later || (q >= kHalo ? q - kHalo >= sh
                                                 : ((wrapped >> (kHalo * p + q)) & 1u) != 0u);
            const float same = (hk[q - sh] == hk[q] && ge) ? 1.0f : 0.0f;
            h[q] = __fadd_rn(h[q], __fmul_rn(h[q - sh], same));
          }
        }
      }
#pragma unroll
      for (int e = 0; e < kRows; ++e) c[ch][e] = h[kHalo + e];
    }
  }

  // sh = 8 m: row i reads row i - 8m, the same slot of thread t - m; rows
  // i < sh (threads t < m) read row i - sh + T, the wrapped row (times 0),
  // the same slot of thread t - m + nt when T % 8 == 0
  int pass = 0;
  for (int sh = kRows; sh < T; sh <<= 1, ++pass) {
    const int m = sh / kRows;
    float* W = (pass & 1) ? buf0 : buf1;  // buf0's last readers passed the barrier before
    const bool from_smem = m >= 32 || lane < m;
    // written for the lanes < m of the next warp, for every thread when
    // m >= 32, and the rows T - sh .. T - 1 that the wrap reads
    if (act && (m >= 32 || lane >= 32 - m || (t + 1) * kRows > T - sh)) {
#pragma unroll
      for (int ch = 0; ch < NC; ++ch) store8(W + ch * Tp, t, c[ch]);
    }
    __syncthreads();
    const bool wrap = t < m;
    const bool wrap_whole = !L::kRagged || T % kRows == 0;
    const int src = wrap ? t - m + nt : t - m;
    float same[kRows];
    if (act) {
      int sk[kRows];
      load8(K, src, sk);
#pragma unroll
      for (int e = 0; e < kRows; ++e)
        same[e] = (sk[e] == k[e] && t * kRows + e >= sh) ? 1.0f : 0.0f;
    }
#pragma unroll
    for (int ch = 0; ch < NC; ++ch) {
      float v[kRows];
      if (m < 32) {  // uniform over the block: shuffles only where a lane can source one
#pragma unroll
        for (int e = 0; e < kRows; ++e) v[e] = __shfl_up_sync(0xffffffffu, c[ch][e], m);
      }
      if (act) {
        if (from_smem) {
          if (!wrap || wrap_whole) {
            load8(W + ch * Tp, src, v);
          } else {
#pragma unroll
            for (int e = 0; e < kRows; ++e) v[e] = W[ch * Tp + T - sh + t * kRows + e];
          }
        }
#pragma unroll
        for (int e = 0; e < kRows; ++e) c[ch][e] = __fadd_rn(c[ch][e], __fmul_rn(v[e], same[e]));
      }
    }
  }

  // the carry: every block but the frame's last publishes its own (last
  // key, last local prefix) at once; block b waits for those of blocks
  // 0 .. b-1 (one thread each) and walks the recurrence from block 0.
  // A frame of more than one block has T % 8 == 0: its last row is slot 7
  // of thread nt - 1.
  if (t == nt - 1 && b < nb - 1) {
    volatile unsigned* mine = pub + kRecordWords * (size_t)tk;
    mine[0] = (unsigned)k[kRows - 1];
#pragma unroll
    for (int ch = 0; ch < NC; ++ch) mine[1 + ch] = __float_as_uint(c[ch][kRows - 1]);
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
      const volatile unsigned* pv = pub + kRecordWords * (size_t)q;
      lk[j] = (int)pv[0];
      for (int ch = 0; ch < NC; ++ch) lv[NC * j + ch] = __uint_as_float(pv[1 + ch]);
    }
    __syncthreads();
    if (t == 0) {
      int key = lk[0];
      float cv[NC];
      for (int ch = 0; ch < NC; ++ch) cv[ch] = lv[ch];
      for (int j = 1; j < b; ++j) {  // block j's last output
        const float mk = lk[j] == key ? 1.0f : 0.0f;
        for (int ch = 0; ch < NC; ++ch) cv[ch] = __fadd_rn(lv[NC * j + ch], __fmul_rn(mk, cv[ch]));
        key = lk[j];
      }
      s_ck = key;
      for (int ch = 0; ch < NC; ++ch) s_carry[ch] = cv[ch];
    }
  }
  __syncthreads();  // also: every reader of buf1 is done
  if (act) {
    const int ck = b > 0 ? s_ck : 0;
#pragma unroll
    for (int ch = 0; ch < NC; ++ch) {
      if (b > 0) {
        const float cv = s_carry[ch];
#pragma unroll
        for (int e = 0; e < kRows; ++e) {
          const float mk = k[e] == ck ? 1.0f : 0.0f;
          c[ch][e] = __fadd_rn(c[ch][e], __fmul_rn(mk, cv));
        }
      }
      store8(buf1 + ch * Tp, t, c[ch]);
    }
  }
  __syncthreads();
  lay.store(buf1, base, T, Tp);
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

size_t g_k7_smem[16], g_k9_smem[16];

template <class L>
int launch_chain(const int* ks, const L& lay, int S, int N, int T, unsigned* chain, int cap,
                 size_t (&smem_set)[16], cudaStream_t st) {
  constexpr int NC = L::NC;
  const int Tp = (T + kRows - 1) / kRows * kRows;
  const int nb = N / T;
  // the look-back's summaries of blocks 0 .. nb-2 fit in one channel buffer
  if ((long long)(nb - 1) * (1 + NC) > (long long)NC * Tp) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)Tp * (1 + 2 * NC) * sizeof(float);
  cudaError_t err = allow_smem(seg_chain_kernel<L>, smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const int threads = (Tp / kRows + 31) / 32 * 32;
  seg_chain_kernel<L><<<S * nb, threads, smem, st>>>(ks, lay, N, T, nb, chain, cap);
  return (int)cudaGetLastError();
}

}  // namespace

// K7.  ks (S, N) i32 sorted per row; channel c of row r of frame s is
// vc[(s * N + p) * vstride] with p = perm[s * N + r] (i64, a row of the
// frame) or p = r when perm is null; N % T == 0, T % 128 == 0, T <= 8192.
// Outputs ox, oy, oz (S, N) f32 (16-byte aligned).  chain: u32 scratch of
// 2 + 6 * cap words, zero before the first launch on a stream and left
// zero by every launch; cap >= S * N / T.
extern "C" int motl_segment_totals(const int* ks, const float* xs, const float* ys,
                                   const float* zs, int vstride, const int64_t* perm, int S,
                                   int N, int T, float* ox, float* oy, float* oz,
                                   unsigned* chain, int cap, void* stream) {
  if (S < 1 || T <= 0 || T % 128 != 0 || T > kRows * Planar3::kThreads || N % T != 0 ||
      vstride < 1 || (long long)S * (N / T) > cap)
    return (int)cudaErrorInvalidValue;
  const Planar3 lay{xs, ys, zs, vstride, perm, ox, oy, oz};
  return launch_chain(ks, lay, S, N, T, chain, cap, g_k7_smem, (cudaStream_t)stream);
}

// K9.  ks (S, N) i32 sorted per row; vals (S, N, 4) f32; T = min(2048, N),
// N % T == 0.  Output out (S, N, 4) f32 (16-byte aligned).  chain: K7's
// scratch.
extern "C" int motl_segment_totals_rows(const int* ks, const float* vals, int S, int N, int T,
                                        float* out, unsigned* chain, int cap, void* stream) {
  if (S < 1 || T <= 0 || T > kRows * Rows4::kThreads || N % T != 0 ||
      (T % kRows != 0 && N != T) || (long long)S * (N / T) > cap)
    return (int)cudaErrorInvalidValue;
  const Rows4 lay{vals, out};
  return launch_chain(ks, lay, S, N, T, chain, cap, g_k9_smem, (cudaStream_t)stream);
}
