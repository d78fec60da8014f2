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
// What bounds it on the H100: latency.  The sweeps are serial and each
// reads the frame's whole adjacency, M * M / 8 bytes (128 KB at M = 1,024,
// the headline's m_max_dynamic; 512 KB at M = 2,048, the default); the
// bytes the call must move are a few KB.  Design, one launch per call: one
// thread-block cluster of C CTAs per frame (ops/cluster_pallas.py::
// cc_layout), rank r owning rows r, r + C, r + 2C, ... (R = ceil(M / C) of
// them; interleaved, so the valid rows, which compact_points puts first,
// spread over every rank):
//  1. prep, in every CTA redundantly: the frame staged in shared memory,
//     the count, the tree column sum, p and sq of all M rows;
//  2. adjacency: each CTA builds its rows' bit words (bit b of word w of
//     row i: the pair (i, 32 w + b)), a warp testing one column against 32
//     rows at a time, straight into its own shared memory -- or, past what
//     the cluster's shared memory holds, into a device-memory scratch that
//     only this CTA touches;
//  3. sweeps: every CTA keeps all M labels, double-buffered in shared
//     memory; each sweep a row takes min(old, min over set bits of old[j])
//     -- Jacobi, reading only the previous sweep -- over a group of up to
//     32 lanes (a word each, reduced by shuffles), and writes a changed
//     value into every rank's next buffer over distributed shared memory; one
//     cluster barrier ends the sweep, after each rank ORed its "changed"
//     vote into every rank's vote word (triple-buffered, so one barrier per
//     sweep suffices); the loop ends when no row changed or after n_sweeps.
// When tol2 < 3e38 no pair with an invalid row can pass the test (its sq is
// 3e38 and its p is 0 or NaN), so invalid rows and columns are skipped:
// only the valid rows' words are tested, and only at valid columns.
// The cc_adjacency entry (K8a) runs 1 and 2 and writes the bool (M, M)
// matrix of its rows instead of sweeping; the jnp backend (ops/cluster.py)
// sweeps that, so both backends test the same d2 bits.
// Past kMaxRows, where p and sq of the frame alone fill a CTA's shared
// memory, the same steps run with the frame in device memory
// (cc_kernel<., true>): each CTA's p, sq and tree partials in a scratch of
// its own, the adjacency words in device memory, and the labels one
// double-buffered copy per frame in device memory, each rank writing only
// its own rows (st.global.cg) and reading every row from L2 (ld.global.cg);
// the cluster barrier that ends a sweep orders those writes before the next
// sweep's reads.  Only the valid-row bits stay in shared memory.
//
// K8a's double build (motl_cc_adjacency_f64, dtype="float64") is the same
// body on f64 points: the JAX jnp CC's f64 adjacency (ops/cluster.py:
// 51-69), whose jitted CPU code spells its ops as the f32 program does --
// the 32-row tree column sum, sq and the gram as FMA chains (__fma_rn),
// d2 = (sq_i + sq_j) - 2 * gram -- against the f64 tol * tol (found by test
// against the jitted JAX _pairwise_adjacency: tests/
// test_torch_f64_pointlist.py).  In double, p, sq and the partials take
// 32 B a row, so the frame stays in shared memory up to kMaxRowsF64 =
// 4,096 rows and moves to device memory past it.  K8 (the labels) has no
// double build: the JAX Pallas CC casts the points to f32 (cluster_pallas.
// py:132), and so does the port.
//
// K8a's half builds (motl_cc_adjacency_bf16 / _f16, dtype="bfloat16" /
// "float16") are the same body on bf16 / f16 rows, staged as floats, with the
// JAX half adjacency's ops as XLA's jitted CPU code computes them (read
// from the compiled bind_env programs; fp_half.cuh, HalfOps below): the
// 32-row tree column sum in f32 (the products by the 0/1 mask are exact),
// rounded to the half type and divided by the count rounded to it; p =
// (pts - c) rounded, 0 on invalid rows; sq the f32 sum of the squares --
// exact products in bf16, products rounded to f16 in f16 -- rounded once;
// the gram the f32 dot of exact products in ascending order, rounded
// once; d2 = ((sq_i + sq_j) rounded - 2 gram) rounded, against tol * tol
// rounded to the half type.  The frame's bounds are the f32 build's.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "fp_half.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWindow = 32;       // XLA's tree-reduction window on the CPU
constexpr int kMaxRows = 8192;    // M; its P and sq fill 128 KB of shared memory
constexpr int kMaxRowsF64 = 4096; // the same bytes in double
constexpr int kMaxDeviceRows = 65536;  // M with the frame in device memory
constexpr int kMaxCluster = 16;   // non-portable on the H100 (portable: 8)
constexpr float kInvalidSq = 3e38f;

template <class T>
struct Frame {
  const T* pts;         // (M, 3) rows of frame s at pts + s * pfs
  int pfs;
  const uint8_t* mask;  // (M,) at mask + s * mfs
  int mfs;
};

// The float ops of the f32 and f64 builds (T's own, as the header lists).
template <class T>
struct ExactOps {
  using in_t = T;  // the points' type in memory
  static __device__ __forceinline__ T load(T x) { return x; }
  static __device__ __forceinline__ T centre(T sum, int cnt) {
    return fp::div(sum, fmax((T)cnt, T(1)));
  }
  static __device__ __forceinline__ T centred(T v, T c, bool in) {
    return fp::mul(fp::sub(v, c), in ? T(1) : T(0));
  }
  static __device__ __forceinline__ T sq(T p0, T p1, T p2) {
    return fp::fma(p2, p2, fp::fma(p1, p1, fp::mul(p0, p0)));
  }
  static __device__ __forceinline__ T d2(T x, T y, T z, T xj, T yj, T zj, T sqi, T sqj) {
    const T g = fp::fma(z, zj, fp::fma(y, yj, fp::mul(x, xj)));
    return fp::sub(fp::add(sqi, sqj), fp::mul(T(2), g));
  }
};

// The half builds' ops (policy H of fp_half.cuh) on half values held in
// floats: the JAX half adjacency as the header lists it.
template <class H>
struct HalfOps {
  using in_t = typename H::storage;
  static __device__ __forceinline__ float load(in_t x) { return H::load(x); }
  static __device__ __forceinline__ float centre(float sum, int cnt) {
    return fp::hdiv<H>(H::rnd(sum), H::rnd((float)max(cnt, 1)));
  }
  static __device__ __forceinline__ float centred(float v, float c, bool in) {
    return in ? fp::hsub<H>(v, c) : 0.0f;
  }
  static __device__ __forceinline__ float square(float a) {
    // XLA's f16 program keeps the f16 square; its bf16 one drops the
    // rounding of the product (a convert pair simplified away)
    return std::is_same<H, fp::F16>::value ? fp::hmul<H>(a, a) : __fmul_rn(a, a);
  }
  static __device__ __forceinline__ float sq(float p0, float p1, float p2) {
    return H::rnd(__fadd_rn(__fadd_rn(square(p0), square(p1)), square(p2)));
  }
  static __device__ __forceinline__ float d2(float x, float y, float z, float xj, float yj,
                                             float zj, float sqi, float sqj) {
    const float g = H::rnd(__fadd_rn(__fadd_rn(__fmul_rn(x, xj), __fmul_rn(y, yj)),
                                     __fmul_rn(z, zj)));
    return fp::hsub<H>(fp::hadd<H>(sqi, sqj), fp::hmul<H>(2.0f, g));
  }
};

// P, SQ and the tree partials of one CTA: 4M + 6 ceil(M / 32) values.
__host__ __device__ inline size_t frame_floats(int M) {
  return 4 * (size_t)M + 6 * (size_t)((M + kWindow - 1) / kWindow);
}

// The adjacency words of R rows in shared memory, rounded to 8 bytes in
// the double build so that P behind them stays aligned.
template <class T>
__host__ __device__ inline size_t bits_words(int W, int R) {
  const size_t w = (size_t)(W + 1) * R;
  return sizeof(T) == 8 ? (w + 1) & ~(size_t)1 : w;
}

// A label of the sweeps: from L2 when the labels lie in device memory
// (another SM's rank wrote it), else from shared memory.
template <bool kDeviceFrame>
__device__ __forceinline__ int ld_label(const int* p) {
  if constexpr (kDeviceFrame) return __ldcg(p);
  else return *p;
}

// Shared memory: [bits (R rows of W + 1 u32: the odd row stride keeps both
// the build's column walk and the sweeps' row walk free of bank conflicts)
// when they fit][P (3M) | SQ (M) | tree partials, of T] -- the last region
// holds the labels (2M i32) once the adjacency is built.  With kDeviceFrame it
// holds the valid-row bits alone (W u32); P, SQ and the partials lie at
// frame_global + blockIdx.x * frame_floats(M), the bits in bits_global, the
// labels of frame s at lab_global + 2 s M.
template <class T, class O, bool kLabels, bool kDeviceFrame>
__global__ void __launch_bounds__(kThreads)
cc_kernel(Frame<typename O::in_t> f, int M, T tol2, int n_sweeps, int C, int R, int bits_in_smem,
          unsigned* __restrict__ bits_global, T* __restrict__ frame_global,
          int* __restrict__ lab_global, int* __restrict__ labels,
          int* __restrict__ sweeps, uint8_t* __restrict__ adj) {
  extern __shared__ unsigned sm[];
  __shared__ unsigned s_vm[kDeviceFrame ? 1 : kMaxRows / 32];  // valid rows, one bit each
  unsigned* vm = kDeviceFrame ? sm : s_vm;
  __shared__ T s_c[3];
  __shared__ int s_cnt;
  __shared__ int s_vote[3];
  const int rank = (int)(blockIdx.x % C);  // K8: the cluster rank; K8a: CTAs are independent
  const int s = blockIdx.x / C;
  const int W = (M + 31) / 32, Wp = W + 1;
  const int t = threadIdx.x;
  const typename O::in_t* X = f.pts + (size_t)s * f.pfs;
  const uint8_t* MK = f.mask + (size_t)s * f.mfs;
  unsigned* bits = (!kDeviceFrame && bits_in_smem) ? sm : bits_global + (size_t)blockIdx.x * Wp * R;
  T* P = kDeviceFrame ? frame_global + (size_t)blockIdx.x * frame_floats(M)
                      : reinterpret_cast<T*>(bits_in_smem ? sm + bits_words<T>(W, R) : sm);
  T* SQ = P + 3 * M;
  const int nb0 = (M + kWindow - 1) / kWindow;
  T* part[2] = {SQ + M, SQ + M + 3 * nb0};
  const T invalid_sq = T(kInvalidSq);
  const bool prune = tol2 < invalid_sq;

  // ---- 1. prep: count, tree column sum, p, sq (every CTA, all rows) ------
  if (t == 0) s_cnt = 0;
  for (int w = t; w < W; w += blockDim.x) vm[w] = 0u;
  if (t < 3) s_vote[t] = 0;
  __syncthreads();
  int local = 0;
  for (int q = t; q < 3 * M; q += blockDim.x) P[q] = O::load(X[q]);  // the frame, staged
  for (int i = t; i < M; i += blockDim.x) {
    if (MK[i]) {
      ++local;
      atomicOr(&vm[i >> 5], 1u << (i & 31));
    }
  }
  atomicAdd(&s_cnt, local);
  __syncthreads();
  auto valid = [&](int i) { return (vm[i >> 5] >> (i & 31)) & 1u; };
  for (int q = t; q < 3 * nb0; q += blockDim.x) {  // windows of 32 rows of pts * mask
    const int k = q / nb0, b = q - k * nb0;
    T a = T(0);
    for (int i = b * kWindow; i < min(M, (b + 1) * kWindow); ++i)
      a = fp::add(a, fp::mul(P[3 * i + k], valid(i) ? T(1) : T(0)));
    part[0][q] = a;
  }
  __syncthreads();
  int n = nb0, cur = 0;
  while (n > kWindow) {  // further levels while more than 32 partials remain
    const int nb = (n + kWindow - 1) / kWindow;
    for (int q = t; q < 3 * nb; q += blockDim.x) {
      const int k = q / nb, b = q - k * nb;
      T a = T(0);
      for (int i = b * kWindow; i < min(n, (b + 1) * kWindow); ++i)
        a = fp::add(a, part[cur][k * n + i]);
      part[1 - cur][q] = a;
    }
    __syncthreads();
    n = nb;
    cur = 1 - cur;
  }
  if (t < 3) {
    T a = T(0);
    for (int i = 0; i < n; ++i) a = fp::add(a, part[cur][t * n + i]);
    s_c[t] = O::centre(a, s_cnt);
  }
  __syncthreads();
  for (int i = t; i < M; i += blockDim.x) {  // in place: row i is this thread's alone
    const bool in = valid(i);
    const T p0 = O::centred(P[3 * i], s_c[0], in);
    const T p1 = O::centred(P[3 * i + 1], s_c[1], in);
    const T p2 = O::centred(P[3 * i + 2], s_c[2], in);
    P[3 * i] = p0;
    P[3 * i + 1] = p1;
    P[3 * i + 2] = p2;
    SQ[i] = in ? O::sq(p0, p1, p2) : invalid_sq;
  }
  __syncthreads();

  // ---- 2. this rank's adjacency words, bits[il * Wp + w] of row il C + rank
  // (rows fastest across threads: a warp tests one column j at a time, four
  // columns in flight)
  for (int q = t; q < W * R; q += blockDim.x) {
    const int il = q % R, w = q / R;
    const int i = il * C + rank;
    unsigned word = 0u;
    if (i < M && (!prune || valid(i))) {
      const T x = P[3 * i], y = P[3 * i + 1], z = P[3 * i + 2], sqi = SQ[i];
      const int nj = min(32, M - 32 * w);
      unsigned cand = prune ? vm[w] : (nj == 32 ? 0xffffffffu : (1u << nj) - 1u);
      while (cand) {
        int bb[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          bb[u] = cand ? __ffs(cand) - 1 : -1;
          cand &= cand - 1u;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (bb[u] < 0) continue;
          const int j = 32 * w + bb[u];
          const T d2 = O::d2(x, y, z, P[3 * j], P[3 * j + 1], P[3 * j + 2], sqi, SQ[j]);
          if (d2 <= tol2) word |= 1u << bb[u];
        }
      }
    }
    bits[il * Wp + w] = word;
  }
  __syncthreads();

  if constexpr (!kLabels) {
    // ---- K8a: the bool rows of this rank, adj[s][i][j] ----------------------
    uint8_t* A = adj + (size_t)s * M * M;
    if (M % 16 == 0) {
      const int nc = M / 16;  // 16-byte chunks per row
      for (int q = t; q < R * nc; q += blockDim.x) {
        const int il = q / nc, j0 = 16 * (q - il * nc);
        if (il * C + rank >= M) break;
        const unsigned half = (bits[il * Wp + (j0 >> 5)] >> (j0 & 31)) & 0xffffu;
        unsigned v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          v[k] = ((half >> (4 * k)) & 1u) | (((half >> (4 * k + 1)) & 1u) << 8) |
                 (((half >> (4 * k + 2)) & 1u) << 16) | (((half >> (4 * k + 3)) & 1u) << 24);
        *reinterpret_cast<uint4*>(A + (size_t)(il * C + rank) * M + j0) =
            make_uint4(v[0], v[1], v[2], v[3]);
      }
    } else {
      for (int q = t; q < R * M; q += blockDim.x) {
        const int il = q / M, j = q - il * M;
        if (il * C + rank >= M) break;
        A[(size_t)(il * C + rank) * M + j] = (uint8_t)((bits[il * Wp + (j >> 5)] >> (j & 31)) & 1u);
      }
    }
    return;
  } else {

  // ---- 3. Jacobi sweeps over the cluster ------------------------------------
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = t & 31, warp = t >> 5, nwarps = blockDim.x >> 5;
  int G = 1;  // lanes per row: the words of a row, up to a warp
  while (G < 32 && G < W) G <<= 1;
  const int rpw = 32 / G;  // rows per warp and step
  int* lab[2] = {reinterpret_cast<int*>(P), reinterpret_cast<int*>(P) + M};
  if (kDeviceFrame) {  // one copy per frame: each rank sets its own rows
    lab[0] = lab_global + (size_t)s * 2 * M;
    lab[1] = lab[0] + M;
    for (int il = t; il < R && il * C + rank < M; il += blockDim.x) {
      const int i = il * C + rank, v = valid(i) ? i : M;
      __stcg(lab[0] + i, v);
      __stcg(lab[1] + i, v);
    }
  } else {
    for (int i = t; i < M; i += blockDim.x) {
      const int v = valid(i) ? i : M;
      lab[0][i] = v;
      lab[1][i] = v;
    }
  }
  cluster.sync();  // every rank's labels set (its P and sq no longer read)
  int it = 0;
  while (it < n_sweeps) {
    const int* cur_l = lab[it & 1];
    int* nxt_l = lab[(it + 1) & 1];
    int changed = 0;
    // a group of G lanes per row, each lane a word in G, min over the group
    for (int r0 = warp * rpw; r0 < R; r0 += nwarps * rpw) {
      const int il = r0 + lane / G, i = il * C + rank;
      const bool live = il < R && i < M && (!prune || valid(i));
      int nmin = M;
      if (live) {
        for (int w = lane % G; w < W; w += G) {
          unsigned word = bits[il * Wp + w];
          while (word) {  // four labels in flight
            int bb[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              bb[u] = word ? __ffs(word) - 1 : -1;
              word &= word - 1u;
            }
#pragma unroll
            for (int u = 0; u < 4; ++u)
              if (bb[u] >= 0) nmin = min(nmin, ld_label<kDeviceFrame>(cur_l + 32 * w + bb[u]));
          }
        }
      }
      for (int off = G / 2; off > 0; off >>= 1)
        nmin = min(nmin, __shfl_xor_sync(0xffffffffu, nmin, off));
      if (live && lane % G == 0) {
        const int old = ld_label<kDeviceFrame>(cur_l + i);
        const int nv = min(old, nmin);
        changed |= nv != old;
        if (kDeviceFrame) {
          __stcg(nxt_l + i, nv);
        } else if (nxt_l[i] != nv) {
          // every rank's copies are equal after each sweep: write where the
          // next buffer (two sweeps old) differs
          for (int r = 0; r < C; ++r) cluster.map_shared_rank(nxt_l, r)[i] = nv;
        }
      }
    }
    if (__syncthreads_or(changed) && t == 0)
      for (int r = 0; r < C; ++r) atomicOr(cluster.map_shared_rank(&s_vote[it % 3], r), 1);
    cluster.sync();  // every next buffer complete, every vote in
    const int v = s_vote[it % 3];
    // the word of sweep it + 2: its last reader (this CTA, sweep it - 1)
    // is past, its first writer waits for this CTA at the next barrier
    if (t == 0) s_vote[(it + 2) % 3] = 0;
    ++it;
    if (!v) break;
  }
  const int* fin = lab[it & 1];
  for (int il = t; il < R && il * C + rank < M; il += blockDim.x)
    labels[(size_t)s * M + il * C + rank] = ld_label<kDeviceFrame>(fin + il * C + rank);
  if (rank == 0 && t == 0) sweeps[s] = it;
  }
}

// Once per process and device: a kernel's shared-memory limit and its
// non-portable cluster size.
template <class T, class O, bool kLabels, bool kDeviceFrame>
cudaError_t allow(size_t smem) {
  static size_t set[16];
  int d = 0;
  cudaError_t err = cudaGetDevice(&d);
  if (err != cudaSuccess) return err;
  if (d < 16 && set[d] >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(cc_kernel<T, O, kLabels, kDeviceFrame>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && kLabels)
    err = cudaFuncSetAttribute(cc_kernel<T, O, kLabels, kDeviceFrame>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && d < 16) set[d] = smem;
  return err;
}

template <class T>
size_t smem_bytes(int M, int R, bool bits_in_smem) {
  const int W = (M + 31) / 32;
  const size_t region = max(sizeof(T) * frame_floats(M), (size_t)8 * M);
  return region + (bits_in_smem ? 4 * bits_words<T>(W, R) : 0);
}

template <class T, class O, bool kLabels, bool kDeviceFrame>
int launch(const Frame<typename O::in_t>& f, int S, int M, T tol2, int n_sweeps, int cluster,
           unsigned* bits_global, T* frame_global, int* lab_global, int* labels,
           int* sweeps, uint8_t* adj, cudaStream_t st) {
  const int max_rows = kDeviceFrame ? kMaxDeviceRows : (sizeof(T) == 8 ? kMaxRowsF64 : kMaxRows);
  if (S < 1 || M < 1 || M > max_rows || cluster < 1 || cluster > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  if (kDeviceFrame && (bits_global == nullptr || (kLabels && lab_global == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int R = (M + cluster - 1) / cluster;
  const bool in_smem = bits_global == nullptr;
  const size_t smem = kDeviceFrame ? (size_t)4 * ((M + 31) / 32) : smem_bytes<T>(M, R, in_smem);
  cudaError_t err = allow<T, O, kLabels, kDeviceFrame>(smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S * cluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kLabels ? 1 : 0;  // K8a's CTAs share nothing
  err = cudaLaunchKernelEx(&cfg, cc_kernel<T, O, kLabels, kDeviceFrame>, f, M, tol2, n_sweeps,
                           cluster, R, (int)in_smem, bits_global, frame_global, lab_global,
                           labels, sweeps, adj);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <class T, class O = ExactOps<T>>
int adjacency(const typename O::in_t* pts, int pfs, const uint8_t* mask, int mfs, int S, int M,
              T tol2, int cluster, unsigned* bits_global, T* frame_global, uint8_t* adj,
              void* stream) {
  const Frame<typename O::in_t> f{pts, pfs, mask, mfs};
  const cudaStream_t st = (cudaStream_t)stream;
  if (frame_global)
    return launch<T, O, false, true>(f, S, M, tol2, 0, cluster, bits_global, frame_global,
                                     nullptr, nullptr, nullptr, adj, st);
  return launch<T, O, false, false>(f, S, M, tol2, 0, cluster, bits_global, nullptr, nullptr,
                                    nullptr, nullptr, adj, st);
}

}  // namespace

// pts: S frames of (M, 3) f32 rows, frame s at pts + s * pfs floats; mask:
// S frames of M bytes (nonzero = valid), frame s at mask + s * mfs.
// `cluster` CTAs per frame (1-16); bits_global null keeps the adjacency in
// shared memory, else it is a scratch of S * cluster * (ceil(M / 32) + 1) *
// ceil(M / cluster) u32.  frame_global null keeps the frame in shared memory
// (M <= 8,192); else it is a scratch of S * cluster * (4 M + 6 ceil(M / 32))
// f32 and then S * 2 M i32 for K8's labels (M <= 65,536; bits_global then
// required).

// K8a: adj (S, M, M) bool (one byte each), row i column j set when rows i
// and j are adjacent.
extern "C" int motl_cc_adjacency(const float* pts, int pfs, const uint8_t* mask, int mfs, int S,
                                 int M, float tol2, int cluster, unsigned* bits_global,
                                 float* frame_global, uint8_t* adj, void* stream) {
  return adjacency<float>(pts, pfs, mask, mfs, S, M, tol2, cluster, bits_global, frame_global,
                          adj, stream);
}

// K8a's double build: pts and frame_global f64 (frame_global then S *
// cluster * (4 M + 6 ceil(M / 32)) f64; the frame in shared memory up to
// M = 4,096), tol2 the f64 tol * tol; the rest as motl_cc_adjacency.
extern "C" int motl_cc_adjacency_f64(const double* pts, int pfs, const uint8_t* mask, int mfs,
                                     int S, int M, double tol2, int cluster,
                                     unsigned* bits_global, double* frame_global, uint8_t* adj,
                                     void* stream) {
  return adjacency<double>(pts, pfs, mask, mfs, S, M, tol2, cluster, bits_global, frame_global,
                           adj, stream);
}

// K8a's half builds: pts bf16 (motl_cc_adjacency_bf16) or f16 (_f16) rows,
// frame_global f32 (the half values widened), tol2 tol * tol rounded to the
// half type (a float); the rest, the frame's bounds included, as
// motl_cc_adjacency.
extern "C" int motl_cc_adjacency_bf16(const __nv_bfloat16* pts, int pfs, const uint8_t* mask,
                                      int mfs, int S, int M, float tol2, int cluster,
                                      unsigned* bits_global, float* frame_global, uint8_t* adj,
                                      void* stream) {
  return adjacency<float, HalfOps<fp::BF16>>(pts, pfs, mask, mfs, S, M, tol2, cluster,
                                             bits_global, frame_global, adj, stream);
}

extern "C" int motl_cc_adjacency_f16(const __half* pts, int pfs, const uint8_t* mask, int mfs,
                                     int S, int M, float tol2, int cluster,
                                     unsigned* bits_global, float* frame_global, uint8_t* adj,
                                     void* stream) {
  return adjacency<float, HalfOps<fp::F16>>(pts, pfs, mask, mfs, S, M, tol2, cluster,
                                            bits_global, frame_global, adj, stream);
}

// K8: labels (S, M) i32; sweeps (S,) i32 the sweeps run (the last one
// changed nothing unless the cap cut the loop).
extern "C" int motl_cc_labels(const float* pts, int pfs, const uint8_t* mask, int mfs, int S,
                              int M, float tol2, int n_sweeps, int cluster,
                              unsigned* bits_global, float* frame_global, int* labels,
                              int* sweeps, void* stream) {
  const Frame<float> f{pts, pfs, mask, mfs};
  const cudaStream_t st = (cudaStream_t)stream;
  if (frame_global) {
    int* lab_global = reinterpret_cast<int*>(frame_global + (size_t)S * cluster * frame_floats(M));
    return launch<float, ExactOps<float>, true, true>(f, S, M, tol2, n_sweeps, cluster,
                                                      bits_global, frame_global, lab_global,
                                                      labels, sweeps, nullptr, st);
  }
  return launch<float, ExactOps<float>, true, false>(f, S, M, tol2, n_sweeps, cluster,
                                                     bits_global, nullptr, nullptr, labels,
                                                     sweeps, nullptr, st);
}
