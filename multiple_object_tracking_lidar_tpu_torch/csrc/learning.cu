// K13: one SGD step of the IHGP hyperparameter learning for A stacked
// problems, one launch: a grid of G x A CTAs of 512 threads, G = ceil(B /
// 32), each CTA 32 windows (one chunk of the masked sums) of one problem.
//
// Replaces the JAX package's jitted jnp step (multiple_object_tracking_lidar_tpu/
// models/learning.py::learning_step :121, with models/ihgp.py::ihgp_nll_grad
// :312; no TPU kernel), which would be thousands of small launches as plain
// eager torch.  Every value is the one the plain version computes
// (models/learning.py::learning_step_plain), bit for bit: each product and
// sum is spelled (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, and
// __fmaf_rn exactly where XLA's CPU code fuses a multiply-add, which the
// plain version spells fma32), exp and log are XLA's Cephes polynomials
// (models/f32_math.py), and the sums run in one fixed order.  No float
// atomics.
//
// What bounds it: dependent latency, not bytes or operations.  The DARE and
// the Lyapunov recursion are 100 trips each of a dependent chain, the
// DARE's with an IEEE division in it (~60 cycles on an H100 against ~5 for
// an FMA); the window recursion is a chain over T with seven divisions a
// step.  A division compiles to its own branch region, so two divisions of
// one thread run one after the other.  The design keeps each chain to the
// spelled arithmetic and puts the divisions that do not depend on one
// another on different lanes.
//
// Stage 1, the gains (learning.py::stationary_gains_torch), redone by every
// CTA.  Warp 0: the Matern-3/2 model, A = expm(F dt) (JAX's own f32 expm:
// the 1-norm, scaling, Pade 3/5/7, LU with partial pivoting as LAPACK's
// getf2 + trsm take it, squarings), Q, the 100-trip DARE -- a trip's two
// divisions by s on lanes of the two parities, the other's quotient by a
// shuffle --, S, K, HA, AKHA and AK into shared memory.  Meanwhile lane 0 of
// warps 1-3, one per hyperparameter p and so never diverging on the Pade
// order: the model again, A again (the same code, the same bits), the Van
// Loan 4 x 4 expm, dQ symmetrised and HdA, none of which waits on the DARE;
// warps 4-15 load the CTA's first block of y into shared memory.  After a
// barrier the three lanes take PP and AK: C symmetrised, the 100-trip
// Lyapunov recursion, dS, dK and dAKHA into shared memory.  (G, the
// smoother gain, is not computed: the step does not read it.)
// Stage 2, the windows (ihgp.py::ihgp_nll_grad from m0 = 0), kSteps steps
// of y at a time in shared memory: (A) warp p < 3, lane w: window w's m and
// hyperparameter p's dm in turn over the steps, each step's seven numerators
// (vv; v dv and vv dS for each p) to shared memory; (B) all 512 threads:
// the block's divisions, which depend on nothing but their numerator; (C)
// warp q < 4, lane w: window w's value q summed in turn over the steps (the
// NLL and the three gradient entries).  No step's sum is reordered.
// Stage 3, the sums in learning.py::masked_sums's order: warp q sums its
// lanes' values times their mask weight window by window from +0 through
// shuffles; warp 0's ballot counts the windows whose mask is on.  With one
// CTA per problem the total is +0 plus that chunk sum; otherwise each CTA
// writes its chunk sums and adds (windows on << 32) | 1 to the problem's
// 64-bit ticket word (__threadfence, then one integer atomicAdd), and the
// last CTA to arrive reads every chunk sum in coalesced tiles into shared
// memory, sums them in ascending order and stores 0 to the ticket for the
// next launch.  Then the update, one thread per entry: the mean over
// max(sum w, 1), theta * grad, SGD on entries 1 and 2, the clamp to
// [-10, 10] and the reset of a non-finite entry to 0.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kW = 32;                  // windows per CTA: one chunk of the masked sums
constexpr int kThreads = 512;
constexpr int kSums = 4;                // the NLL and the three gradient entries
constexpr int kQuot = 7;                // a window step's divisions: vv / S, and per
                                        // hyperparameter (v dv) / S and (vv dS) / (S S)
constexpr int kSteps = 40;              // steps of y per shared-memory block
constexpr int kStride = kW + 1;         // ys[step][window], padded: no bank conflicts
constexpr int kTile = kSteps * kStride / kSums;  // chunk sums per tile of the final sum
constexpr int kMaxGridY = 65535;
constexpr int kDareIters = 100;
constexpr int kMaxSquarings = 16;
constexpr int kChunk = 32;              // learning.py::SUM_CHUNK
constexpr float kFltMin = 1.17549435e-38f;

__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float ffma(float a, float b, float c) { return __fmaf_rn(a, b, c); }

// ---- f32_math.py ---------------------------------------------------------

__device__ __forceinline__ float pow2(int n) { return __int_as_float((n + 127) << 23); }

__device__ float exp_f32(float x) {
  if (isnan(x)) return x;
  const float xc = fminf(fmaxf(x, -104.0f), 89.0f);
  const float fx = floorf(ffma(xc, 1.44269504088896341f, 0.5f));
  float r = ffma(-0.693359375f, fx, xc);
  r = ffma(2.12194440e-4f, fx, r);
  const float z = fmul(r, r);
  float y = ffma(r, 1.9875691500e-4f, 1.3981999507e-3f);
  y = ffma(y, r, 8.3334519073e-3f);
  y = ffma(y, r, 4.1665795894e-2f);
  y = ffma(y, r, 1.6666665459e-1f);
  y = ffma(y, r, 5.0000001201e-1f);
  y = ffma(y, z, r);
  y = fadd(y, 1.0f);
  int n = (int)fx;
  n = n < -127 ? -127 : (n > 128 ? 128 : n);
  y = n > 0 ? fmul(fmul(y, pow2(n - 1)), 2.0f) : fmul(fmul(y, pow2(n + 1)), 0.5f);
  return y < kFltMin ? 0.0f : y;
}

__device__ float log_f32(float x) {
  const int bits = __float_as_int(fmaxf(x, kFltMin));
  float e = (float)((bits >> 23) - 126);
  float m = __int_as_float((bits & ~0x7F800000) | 0x3F000000);
  const bool small = m < 0.707106781186547524f;
  const float tmp = small ? m : 0.0f;
  m = fsub(m, 1.0f);
  e = fsub(e, small ? 1.0f : 0.0f);
  m = fadd(m, tmp);
  const float x2 = fmul(m, m);
  const float x3 = fmul(x2, m);
  float y = ffma(m, 7.0376836292e-2f, -1.1514610310e-1f);
  float y1 = ffma(m, -1.2420140846e-1f, 1.4249322787e-1f);
  float y2 = ffma(m, 2.0000714765e-1f, -2.4999993993e-1f);
  y = ffma(y, m, 1.1676998740e-1f);
  y1 = ffma(y1, m, -1.6668057665e-1f);
  y2 = ffma(y2, m, 3.3333331174e-1f);
  y = ffma(y, x3, y1);
  y = ffma(y, x3, y2);
  y = ffma(y, x3, fmul(-2.12194440e-4f, e));
  m = ffma(-0.5f, x2, m);
  m = fadd(m, y);
  m = ffma(0.693359375f, e, m);
  if (x == INFINITY) m = x;
  if (x >= 0.0f && x < kFltMin) m = -INFINITY;
  if (x < 0.0f || isnan(x)) m = NAN;
  return m;
}

// ---- small matrices (learning.py::_mm and friends) ------------------------

// C = A B: each entry's first product rounded, each next one fused onto the
// sum in ascending k (XLA's CPU dot).  C must not alias A or B.
template <int M, int K, int N>
__device__ __forceinline__ void mm(const float (&a)[M][K], const float (&b)[K][N],
                                   float (&c)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float acc = fmul(a[i][0], b[0][j]);
#pragma unroll
      for (int k = 1; k < K; ++k) acc = ffma(a[i][k], b[k][j], acc);
      c[i][j] = acc;
    }
}

template <int M, int N>
__device__ __forceinline__ void tr(const float (&a)[M][N], float (&t)[N][M]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) t[j][i] = a[i][j];
}

// the product of three: (a b) c
template <int M, int K, int L, int N>
__device__ __forceinline__ void mm3(const float (&a)[M][K], const float (&b)[K][L],
                                    const float (&c)[L][N], float (&d)[M][N]) {
  float ab[M][L];
  mm(a, b, ab);
  mm(ab, c, d);
}

// H = [1 0] and its transpose as literals, so no trip of a recursion loads
// them.  A product with a literal 1 is exact and may fold to its operand;
// the FMAs with a literal 0 stay (x + 0 * y is not x for an infinite or NaN
// y, or for x = -0), so every value keeps the plain version's bits.
#define K13_H                                                   \
  [[maybe_unused]] const float kH[1][2] = {{1.0f, 0.0f}};       \
  [[maybe_unused]] const float kHt[2][1] = {{1.0f}, {0.0f}}

// Q^-1 P by learning.py::lu_solve: the left-looking getf2 (the U entries'
// dots from their last term, the lower entries' from their first; the
// first row of largest |entry| pivots; the multipliers scaled by the
// pivot's reciprocal), the forward substitution in ascending k, the back
// substitution from the last column.  Q and P are overwritten.
template <int N>
__device__ void lu_solve(float (&q)[N][N], float (&p)[N][N], float (&x)[N][N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int i = 1; i < j; ++i) {
      float d = fmul(q[i][i - 1], q[i - 1][j]);
#pragma unroll
      for (int k = i - 2; k >= 0; --k) d = ffma(q[i][k], q[k][j], d);
      q[i][j] = fsub(q[i][j], d);
    }
    if (j > 0) {
#pragma unroll
      for (int i = j; i < N; ++i) {
        float d = fmul(q[i][0], q[0][j]);
#pragma unroll
        for (int k = 1; k < j; ++k) d = ffma(q[i][k], q[k][j], d);
        q[i][j] = fsub(q[i][j], d);
      }
    }
    int piv = j;
    float best = fabsf(q[j][j]);
#pragma unroll
    for (int i = j + 1; i < N; ++i) {
      const float a = fabsf(q[i][j]);
      if (a > best) {
        piv = i;
        best = a;
      }
    }
#pragma unroll
    for (int i = j + 1; i < N; ++i) {
      if (piv == i) {
#pragma unroll
        for (int c = 0; c < N; ++c) {
          const float t = q[j][c];
          q[j][c] = q[i][c];
          q[i][c] = t;
          const float u = p[j][c];
          p[j][c] = p[i][c];
          p[i][c] = u;
        }
      }
    }
    const float inv = fdiv(1.0f, q[j][j]);
#pragma unroll
    for (int i = j + 1; i < N; ++i) q[i][j] = fmul(q[i][j], inv);
  }
#pragma unroll
  for (int c = 0; c < N; ++c) {
#pragma unroll
    for (int k = 0; k < N; ++k)
#pragma unroll
      for (int i = k + 1; i < N; ++i) p[i][c] = ffma(-q[i][k], p[k][c], p[i][c]);
#pragma unroll
    for (int k = N - 1; k >= 0; --k) {
      x[k][c] = fmul(p[k][c], fdiv(1.0f, q[k][k]));
#pragma unroll
      for (int i = 0; i < k; ++i) p[i][c] = ffma(-x[k][c], q[i][k], p[i][c]);
    }
  }
}

__device__ __forceinline__ float eye(int i, int j) { return i == j ? 1.0f : 0.0f; }

// expm by JAX's f32 algorithm (learning.py::expm_f32); the Pade sums fused
// as learning.py::_poly fuses them
template <int N>
__device__ void expm(const float (&a)[N][N], float (&r)[N][N]) {
  float norm = 0.0f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float s = fabsf(a[0][j]);
#pragma unroll
    for (int i = 1; i < N; ++i) s = fadd(s, fabsf(a[i][j]));
    norm = j == 0 ? s : ((isnan(norm) || isnan(s)) ? NAN : fmaxf(norm, s));
  }
  const float lg = fdiv(log_f32(fdiv(norm, 3.925724783138660f)), log_f32(2.0f));
  float nsq = floorf(lg);
  if (!isnan(nsq)) nsq = fmaxf(nsq, 0.0f);
  if (!(nsq <= (float)kMaxSquarings)) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) r[i][j] = NAN;
    return;
  }
  const int n_sq = (int)nsq;
  const float scale = pow2(n_sq);
  float s[N][N], a2[N][N], a4[N][N], a6[N][N], w[N][N], u[N][N], v[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) s[i][j] = fdiv(a[i][j], scale);
  const int idx = (norm >= 4.258730016922831e-001f ? 1 : 0) +
                  (norm >= 1.880152677804762e+000f ? 1 : 0);
  mm(s, s, a2);
  if (idx == 0) {            // Pade 3: b = (120, 60, 12, 1)
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        w[i][j] = ffma(60.0f, eye(i, j), a2[i][j]);
        v[i][j] = ffma(12.0f, a2[i][j], fmul(120.0f, eye(i, j)));
      }
  } else if (idx == 1) {     // Pade 5: b = (30240, 15120, 3360, 420, 30, 1)
    mm(a2, a2, a4);
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        w[i][j] = ffma(15120.0f, eye(i, j), ffma(420.0f, a2[i][j], a4[i][j]));
        v[i][j] = ffma(30240.0f, eye(i, j),
                      ffma(30.0f, a4[i][j], fmul(3360.0f, a2[i][j])));
      }
  } else {                   // Pade 7
    mm(a2, a2, a4);
    mm(a4, a2, a6);
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        w[i][j] = ffma(8648640.0f, eye(i, j),
                      ffma(277200.0f, a2[i][j], ffma(1512.0f, a4[i][j], a6[i][j])));
        v[i][j] = ffma(17297280.0f, eye(i, j),
                      ffma(1995840.0f, a2[i][j],
                          ffma(56.0f, a6[i][j], fmul(25200.0f, a4[i][j]))));
      }
  }
  mm(s, w, u);
  float pm[N][N], qm[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      pm[i][j] = fadd(u[i][j], v[i][j]);
      qm[i][j] = fsub(v[i][j], u[i][j]);
    }
  lu_solve(qm, pm, r);
  for (int it = 0; it < kMaxSquarings; ++it) {
    if (it < n_sq) {
      float t[N][N];
      mm(r, r, t);
#pragma unroll
      for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j < N; ++j) r[i][j] = t[i][j];
    }
  }
}

// The Matern-3/2 model of log-parameters lp (learning.py::matern32_torch)
struct Model {
  float sigma2, magn, ls, lam, ls2, ls3, F[2][2], Pinf[2][2];
};

__device__ __forceinline__ void model(const float* lp, Model& md) {
  md.sigma2 = exp_f32(lp[0]);
  md.magn = exp_f32(lp[1]);
  md.ls = exp_f32(lp[2]);
  md.lam = fdiv(__fsqrt_rn(3.0f), md.ls);
  md.ls2 = fmul(md.ls, md.ls);
  md.ls3 = fmul(md.ls, md.ls2);
  md.F[0][0] = 0.0f;
  md.F[0][1] = 1.0f;
  md.F[1][0] = fmul(-md.lam, md.lam);
  md.F[1][1] = fmul(-2.0f, md.lam);
  md.Pinf[0][0] = md.magn;
  md.Pinf[0][1] = md.Pinf[1][0] = 0.0f;
  md.Pinf[1][1] = fmul(fmul(md.magn, md.lam), md.lam);
}

// A = expm(F dt)
__device__ __forceinline__ void transition(const Model& md, float dt, float (&A)[2][2]) {
  float fdt[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) fdt[i][j] = fmul(md.F[i][j], dt);
  expm(fdt, A);
}

// the gains of the DARE's solution, which every lane of stage 2 and the
// derivatives' second half read
struct Gains {
  float PP[2][2], PPH[2], S, K[2], HA[2], AKHA[2][2], AK[2];
  float dS[3], dK[3][2], dAKHA[3][2][2], HdA[3][2];
  // what stage 2 and the update would otherwise compute after stage 1, each
  // beside a longer chain: S * S and 0.5 log S beside the Lyapunov
  // recursions, 0.5 log 2 pi beside the DARE, (0.5 dS) / S, and the
  // model's exp(lp[1]) and exp(lp[2])
  float SS, hlS, hl2pi, hdS[3], magn, ls;
};

// warp 0: the model, A, Q, the DARE and the gains.  Every lane runs every
// trip; of its two divisions by s, a lane of parity i takes row i and the
// other row's quotient comes by a shuffle, so a trip waits on one division
// and not two in turn.  Lane 0 writes the results.
__device__ void gains_base(const float* lp, float dt, int lane, Gains& g) {
  K13_H;
  Model md;
  model(lp, md);
  const float sigma2 = md.sigma2;
  float A[2][2], At[2][2], t[2][2], Q[2][2];
  transition(md, dt, A);
  tr(A, At);
  mm3(A, md.Pinf, At, t);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) Q[i][j] = fsub(md.Pinf[i][j], t[i][j]);

  // the DARE: X <- AKB X AKB^T + (K R) K^T + Q, 100 trips
  float X[2][2] = {{1.0f, 0.0f}, {0.0f, 1.0f}};
  for (int it = 0; it < kDareIters; ++it) {
    float hx[1][2], hxh[1][1], xh[2][1], xs[2][1], K[2][1], akb[2][2], akbt[2][2], t1[2][2];
    mm(kH, X, hx);
    mm(hx, kHt, hxh);
    const float s = fadd(hxh[0][0], sigma2);
    mm(X, kHt, xh);
    const int row = lane & 1;
    const float mine = fdiv(row ? xh[1][0] : xh[0][0], s);
    const float other = __shfl_xor_sync(0xffffffffu, mine, 1);
    xs[0][0] = row ? other : mine;
    xs[1][0] = row ? mine : other;
    mm(A, xs, K);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) akb[i][j] = ffma(-K[i][0], kH[0][j], A[i][j]);
    tr(akb, akbt);
    mm3(akb, X, akbt, t1);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        X[i][j] = fadd(ffma(fmul(K[i][0], sigma2), K[j][0], t1[i][j]), Q[i][j]);
  }
  float hp[1][2], hph[1][1], pph[2][1];
  mm(kH, X, hp);
  mm(hp, kHt, hph);
  const float S = fadd(hph[0][0], sigma2);
  mm(X, kHt, pph);
  float K[2][1] = {{fdiv(pph[0][0], S)}, {fdiv(pph[1][0], S)}};
  float HA[1][2], AK[2][1];
  mm(kH, A, HA);
  mm(A, K, AK);
  if (lane != 0) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      g.PP[i][j] = X[i][j];
      g.AKHA[i][j] = ffma(-K[i][0], HA[0][j], A[i][j]);
    }
    g.PPH[i] = pph[i][0];
    g.K[i] = K[i][0];
    g.HA[i] = HA[0][i];
    g.AK[i] = AK[i][0];
  }
  g.S = S;
  g.magn = md.magn;
  g.ls = md.ls;
}

// what lane 0 of warp 1 + p keeps between the two halves of its derivatives
struct VanLoan {
  float A[2][2], At[2][2], dA[2][2], dAt[2][2], dQs[2][2], dR;
};

// the first half for hyperparameter p: the Van Loan expm, dQ symmetrised and
// HdA, which need nothing of the DARE
__device__ void gains_param_pre(const float* lp, int p, float dt, VanLoan& vl, Gains& g) {
  K13_H;
  Model md;
  model(lp, md);
  float dF[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}}, dPinf[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  if (p == 1) {
    dPinf[0][0] = 1.0f;
    dPinf[1][1] = fdiv(3.0f, md.ls2);
  } else if (p == 2) {
    dF[1][0] = fdiv(6.0f, md.ls3);
    dF[1][1] = fdiv(fmul(2.0f, md.lam), md.ls);
    dPinf[1][1] = fdiv(fmul(-6.0f, md.magn), md.ls3);
  }
  vl.dR = p == 0 ? 1.0f : 0.0f;
  transition(md, dt, vl.A);
  tr(vl.A, vl.At);
  float ff[4][4], aa[4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      ff[i][j] = fmul(md.F[i][j], dt);
      ff[i][j + 2] = fmul(0.0f, dt);
      ff[i + 2][j] = fmul(dF[i][j], dt);
      ff[i + 2][j + 2] = fmul(md.F[i][j], dt);
    }
  expm(ff, aa);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      vl.dA[i][j] = aa[i + 2][j];
      vl.dAt[j][i] = aa[i + 2][j];
    }
  float t1[2][2], t2[2][2], t3[2][2], dQ[2][2], hda[1][2];
  mm3(vl.dA, md.Pinf, vl.At, t1);
  mm3(vl.A, dPinf, vl.At, t2);
  mm3(vl.A, md.Pinf, vl.dAt, t3);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) dQ[i][j] = fsub(fsub(fsub(dPinf[i][j], t1[i][j]), t2[i][j]), t3[i][j]);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) vl.dQs[i][j] = fmul(0.5f, fadd(dQ[i][j], dQ[j][i]));
  mm(kH, vl.dA, hda);
  g.HdA[p][0] = hda[0][0];
  g.HdA[p][1] = hda[0][1];
  if (p == 0) g.hl2pi = fmul(0.5f, log_f32(6.283185308f));
}

// the second half, after the DARE: C symmetrised, the Lyapunov recursion,
// dS, dK and dAKHA
__device__ void gains_param_post(int p, const VanLoan& vl, Gains& g) {
  K13_H;
  float PP[2][2], AK[2][1], AKt[1][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) PP[i][j] = g.PP[i][j];
    AK[i][0] = g.AK[i];
    AKt[0][i] = g.AK[i];
  }
  const float S = g.S;
  float c1[2][2], c2[2][2], dapp[2][2], u[2][1], akh[2][2], c4[2][2], C[2][2];
  mm(vl.dA, PP, dapp);
  mm(dapp, vl.At, c1);
  mm3(vl.A, PP, vl.dAt, c2);
  mm(dapp, kHt, u);
  mm(AK, kH, akh);
  mm3(akh, PP, vl.dAt, c4);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float c = fadd(c1[i][j], c2[i][j]);
      c = ffma(-u[i][0], AKt[0][j], c);
      c = fsub(c, c4[i][j]);
      C[i][j] = fadd(ffma(fmul(AK[i][0], vl.dR), AKt[0][j], c), vl.dQs[i][j]);
    }
  float Cs[2][2], ab[2][2], abt[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      Cs[i][j] = fmul(0.5f, fadd(C[i][j], C[j][i]));
      ab[i][j] = ffma(-AK[i][0], kH[0][j], vl.A[i][j]);
    }
  tr(ab, abt);
  // the Lyapunov recursion X <- Abar X Abar^T + C, 100 trips
  float X[2][2] = {{1.0f, 0.0f}, {0.0f, 1.0f}};
  for (int it = 0; it < kDareIters; ++it) {
    float t[2][2];
    mm3(ab, X, abt, t);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) X[i][j] = fadd(t[i][j], Cs[i][j]);
  }
  float hx[1][2], hxh[1][1], xh[2][1];
  mm(kH, X, hx);
  mm(hx, kHt, hxh);
  const float dS = fadd(hxh[0][0], vl.dR);
  mm(X, kHt, xh);
  const float q = fdiv(dS, fmul(S, S));
  float dK[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) dK[i] = ffma(-g.PPH[i], q, fdiv(xh[i][0], S));
  g.dS[p] = dS;
  g.hdS[p] = fdiv(fmul(0.5f, dS), S);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    g.dK[p][i] = dK[i];
#pragma unroll
    for (int j = 0; j < 2; ++j)
      g.dAKHA[p][i][j] = ffma(-g.K[i], g.HdA[p][j], ffma(-dK[i], g.HA[j], vl.dA[i][j]));
  }
}

// steps k0 .. k0 + kc - 1 of the CTA's first nw windows into ys[step][window]:
// consecutive threads read consecutive floats of y
__device__ __forceinline__ void load_y(const float* __restrict__ yb, int nw, int T, int k0,
                                       int kc, float* ys, int tid, int nthreads) {
  for (int e = tid; e < nw * kc; e += nthreads) {
    const int w = e / kc, kk = e - w * kc;
    ys[kk * kStride + w] = yb[(size_t)w * T + k0 + kk];
  }
}

// entry p of the update from the four sums (nll, grad) over the problem's
// windows, one thread each: the mean over max(sum w, 1), theta * grad with
// theta = exp(lp[p]) (magn, ls), SGD on entries 1 and 2, the clamp to
// [-10, 10], a non-finite entry reset to 0; entry 0's thread writes the NLL
__device__ __forceinline__ void update_entry(int p, const float* lp, const float* s,
                                             unsigned n_on, float magn, float ls,
                                             float lr_magn, float lr_ls, float* new_params,
                                             float* nll_out) {
  const float denom = fmaxf((float)n_on, 1.0f);
  const float mean = fdiv(s[p == 0 ? 0 : p + 1], denom);
  float x = lp[0];
  if (p == 0)
    *nll_out = mean;
  else
    x = ffma(p == 1 ? -lr_magn : -lr_ls, fmul(p == 1 ? magn : ls, mean), lp[p]);
  if (!isnan(x)) x = fminf(fmaxf(x, -10.0f), 10.0f);
  new_params[p] = isfinite(x) ? x : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
learning_kernel(const float* __restrict__ log_params, const float* __restrict__ y,
                const uint8_t* __restrict__ mask, int A, int B, int T, float dt, float lr_magn,
                float lr_ls, float* __restrict__ chunk_sums,
                unsigned long long* __restrict__ tickets, float* __restrict__ new_params,
                float* __restrict__ nll_out) {
  static_assert(kW == kChunk && kW == 32 && kSums * kW <= kThreads,
                "a warp per value of the CTA's one chunk");
  __shared__ Gains g;
  __shared__ float lp[3];
  __shared__ float ys[kSteps * kStride];
  __shared__ float quot[kQuot][kSteps][kW];       // a block's numerators, then quotients
  __shared__ float fin[kSums];
  __shared__ unsigned n_on_s;
  __shared__ int last;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = gridDim.x, cta = blockIdx.x;
  const int b0 = cta * kW, nw = min(kW, B - b0);
  // stage 2's threads: (A) warp p < 3, lane w runs window w's m and
  // hyperparameter p's dm; (C) warp q < 4, lane w sums window w's value q;
  // (B) the block's divisions, thread t window t % nw of rows t / nw,
  // t / nw + R, ... of the kQuot x kc rows (q, k)
  const int w = lane, pa = warp < 3 ? warp : 0, qc = warp < kSums ? warp : 0;
  const int R = kThreads / nw, ww = tid % nw, r0 = tid / nw;

  for (int a = blockIdx.y; a < A; a += gridDim.y) {
    const float* yb = y + ((size_t)a * B + b0) * T;
    __syncthreads();                               // the previous problem's reads done
    if (tid < 3) lp[tid] = log_params[a * 3 + tid];
    __syncthreads();

    // stage 1
    VanLoan vl;
    if (warp == 0) {
      gains_base(lp, dt, lane, g);
    } else if (warp < 4) {
      if (lane == 0) gains_param_pre(lp, warp - 1, dt, vl, g);
    } else {
      load_y(yb, nw, T, 0, min(kSteps, T), ys, tid - 4 * 32, kThreads - 4 * 32);
    }
    __syncthreads();
    if (warp >= 1 && warp < 4 && lane == 0) gains_param_post(warp - 1, vl, g);
    if (tid == 0) {
      g.SS = fmul(g.S, g.S);
      g.hlS = fmul(0.5f, log_f32(g.S));
    }
    __syncthreads();

    // stage 2, a block of kSteps steps at a time: (A) the recursions in turn
    // over the steps, each step's numerators to quot; (B) the divisions,
    // independent of one another; (C) each window's sums in turn over the
    // steps -- the NLL ((e + vv / S) + 0.5 log 2 pi) + 0.5 log S, gradient
    // entry p ((g + (v dv) / S) - (vv dS) / (S S)) + (0.5 dS) / S
    float K[2], HA[2], AKHA[2][2], dK[2], dAKHA[2][2], HdA[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      K[i] = g.K[i];
      HA[i] = g.HA[i];
      dK[i] = g.dK[pa][i];
      HdA[i] = g.HdA[pa][i];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        AKHA[i][j] = g.AKHA[i][j];
        dAKHA[i][j] = g.dAKHA[pa][i][j];
      }
    }
    const float S = g.S, SS = g.SS, dS = g.dS[pa];
    const float add1 = qc == 0 ? g.hl2pi : 0.0f, add2 = qc == 0 ? g.hlS : g.hdS[qc - 1];
    float m0 = 0.0f, m1 = 0.0f, dm0 = 0.0f, dm1 = 0.0f, acc = 0.0f;
    for (int k0 = 0; k0 < T; k0 += kSteps) {
      const int kc = min(kSteps, T - k0);
      if (k0 > 0) {
        __syncthreads();
        load_y(yb, nw, T, k0, kc, ys, tid, kThreads);
        __syncthreads();
      }
      if (warp < 3 && w < nw) {
        float yn = ys[w];
        for (int k = 0; k < kc; ++k) {
          const float yk = yn;
          yn = ys[min(k + 1, kc - 1) * kStride + w];      // the next step's, early
          const float v = fsub(yk, ffma(HA[1], m1, fmul(HA[0], m0)));
          const float vv = fmul(fmul(0.5f, v), v);
          const float hm = ffma(HdA[1], m1, fmul(HdA[0], m0));
          const float dmh = ffma(dm1, HA[1], fmul(dm0, HA[0]));
          const float dv = fsub(-hm, dmh);
          if (pa == 0) quot[0][k][w] = vv;
          quot[1 + 2 * pa][k][w] = fmul(v, dv);
          quot[2 + 2 * pa][k][w] = fmul(vv, dS);
          float nd[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float dam = ffma(dAKHA[i][1], m1, fmul(dAKHA[i][0], m0));
            const float dma = ffma(dm1, AKHA[i][1], fmul(dm0, AKHA[i][0]));
            nd[i] = ffma(dK[i], yk, fadd(dam, dma));
          }
          const float n0 = ffma(K[0], yk, ffma(AKHA[0][1], m1, fmul(AKHA[0][0], m0)));
          const float n1 = ffma(K[1], yk, ffma(AKHA[1][1], m1, fmul(AKHA[1][0], m0)));
          m0 = n0;
          m1 = n1;
          dm0 = nd[0];
          dm1 = nd[1];
        }
      }
      __syncthreads();
      if (tid < R * nw) {
        // rows (q, k) stepped by R without a division
        const int dq = R / kc, dk = R - dq * kc;
        int q = r0 / kc, k = r0 - q * kc;
        while (q < kQuot) {
          quot[q][k][ww] = fdiv(quot[q][k][ww], q == 2 || q == 4 || q == 6 ? SS : S);
          k += dk;
          q += dq;
          if (k >= kc) {
            k -= kc;
            ++q;
          }
        }
      }
      __syncthreads();
      if (warp < kSums && w < nw) {
        // four steps' quotients loaded, then summed in turn
        int k = 0;
        if (qc == 0) {
          for (; k + 4 <= kc; k += 4) {
            float x[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) x[i] = quot[0][k + i][w];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc = fadd(fadd(fadd(acc, x[i]), add1), add2);
          }
          for (; k < kc; ++k) acc = fadd(fadd(fadd(acc, quot[0][k][w]), add1), add2);
        } else {
          for (; k + 4 <= kc; k += 4) {
            float x[4], z[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              x[i] = quot[2 * qc - 1][k + i][w];
              z[i] = quot[2 * qc][k + i][w];
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) acc = fadd(fsub(fadd(acc, x[i]), z[i]), add2);
          }
          for (; k < kc; ++k)
            acc = fadd(fsub(fadd(acc, quot[2 * qc - 1][k][w]), quot[2 * qc][k][w]), add2);
        }
      }
    }

    // stage 3: warp q's chunk sum of value q times the mask weight, window
    // by window from +0 through shuffles (every lane the same sum); warp 0's
    // ballot counts the windows on.  One CTA per problem: the sum over the
    // chunks is +0 + that.  Otherwise each CTA's chunk sums go to
    // chunk_sums and the problem's last CTA to arrive sums them in turn.
    if (warp < kSums) {
      const bool on = w < nw && mask[(size_t)a * B + b0 + w] != 0;
      const float val = fmul(acc, on ? 1.0f : 0.0f);
      float s = 0.0f;
      for (int j = 0; j < nw; ++j) s = fadd(s, __shfl_sync(0xffffffffu, val, j));
      const unsigned n_on = __popc(__ballot_sync(0xffffffffu, on));
      if (lane == 0) {
        if (G == 1) {
          fin[qc] = fadd(0.0f, s);
        } else {
          chunk_sums[((size_t)a * G + cta) * kSums + qc] = s;
          __threadfence();
        }
        if (qc == 0) n_on_s = n_on;
      }
    }
    __syncthreads();
    if (G > 1) {
      // the last CTA to arrive: its count and its arrival in one atomic,
      // the windows on in the high word, the CTAs in the low
      if (tid == 0) {
        const unsigned long long old =
            atomicAdd(&tickets[a], ((unsigned long long)n_on_s << 32) | 1ull);
        last = (unsigned)old == (unsigned)(G - 1);
        if (last) {
          n_on_s += (unsigned)(old >> 32);
          tickets[a] = 0ull;
        }
      }
      __syncthreads();
      if (!last) continue;
      float s = 0.0f;
      for (int c0 = 0; c0 < G; c0 += kTile) {
        const int n = min(kTile, G - c0);
        __syncthreads();
        const float* src = chunk_sums + ((size_t)a * G + c0) * kSums;
        for (int e = tid; e < n * kSums; e += kThreads) ys[e] = __ldcg(src + e);
        __syncthreads();
        if (tid < kSums) {
#pragma unroll 8
          for (int j = 0; j < n; ++j) s = fadd(s, ys[j * kSums + tid]);
        }
      }
      if (tid < kSums) fin[tid] = s;
      __syncthreads();
    }
    if (tid < 3)
      update_entry(tid, lp, fin, n_on_s, g.magn, g.ls, lr_magn, lr_ls, new_params + a * 3,
                   nll_out + a);
  }
}

}  // namespace

// A problems: log_params (A, 3) f32, y (A, B, T) f32 mean-centred windows,
// mask (A, B) u8; chunk_sums (A, ceil(B / 32), 4) f32 (no need to zero it;
// unread with one CTA per problem, B <= 32); tickets (A,) u64, zero, left
// zero by every launch (one buffer per stream).  Outputs new_params (A, 3)
// and nll (A,) f32.  A >= 1, 1 <= B <= 2^24 (the mask count stays exact in
// f32), T >= 1.
extern "C" int motl_learning_step(const float* log_params, const float* y, const uint8_t* mask,
                                  int A, int B, int T, float dt, float lr_magn, float lr_ls,
                                  float* chunk_sums, unsigned long long* tickets,
                                  float* new_params, float* nll, void* stream) {
  if (A < 1 || B < 1 || B > (1 << 24) || T < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((B + kW - 1) / kW, A < kMaxGridY ? A : kMaxGridY);
  learning_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      log_params, y, mask, A, B, T, dt, lr_magn, lr_ls, chunk_sums, tickets, new_params, nll);
  return (int)cudaGetLastError();
}
