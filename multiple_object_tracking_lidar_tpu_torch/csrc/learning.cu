// K13: one SGD step of the IHGP hyperparameter learning, one CTA per
// problem, one launch for A stacked problems.
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
// Stage 1, the gains (learning.py::stationary_gains_torch).  Thread 0: the
// Matern-3/2 model, A = expm(F dt) (JAX's own f32 expm: the 1-norm,
// scaling, Pade 3/5/7, LU with partial pivoting as LAPACK's getf2 + trsm
// take it, squarings), Q, the 100-trip DARE, S, K, HA, AKHA and AK into
// shared memory.  (G, the smoother gain, is not computed: the step does not
// read it.)  Then threads 0-2, one per hyperparameter: the Van Loan 4 x 4
// expm, dQ and C symmetrised, the 100-trip Lyapunov recursion, dS, dK,
// dAKHA and HdA into shared memory.
// Stage 2, the windows (ihgp.py::ihgp_nll_grad from m0 = 0): one thread
// per window, looping past 256, the recursion's state (m, dm, edata,
// gdata) in registers; each window's (nll, grad) times its mask weight to
// a scratch row.
// Stage 3, the update: the sums in learning.py::masked_sums's order (each
// 32-window chunk in turn by one thread, then the chunk sums in turn by
// thread 0), the mean over max(sum w, 1), theta * grad, SGD on entries 1
// and 2, the clamp to [-10, 10] and the reset of a non-finite entry to 0.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
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

__device__ const float kH[1][2] = {{1.0f, 0.0f}};
__device__ const float kHt[2][1] = {{1.0f}, {0.0f}};

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

struct Gains {
  // stage 1, thread 0
  float F[2][2], Pinf[2][2], R, dF[3][2][2], dPinf[3][2][2], dR[3];
  float A[2][2], PP[2][2], PPH[2][1], S, K[2][1], HA[1][2], AKHA[2][2], AK[2][1];
  // stage 1, threads 0-2
  float dS[3], dK[3][2], dAKHA[3][2][2], HdA[3][2];
};

// thread 0: the model, A, Q, the DARE and the gains (stationary_gains_torch)
__device__ void gains_base(const float* lp, float dt, Gains& g) {
  const float sigma2 = exp_f32(lp[0]), magn = exp_f32(lp[1]), ls = exp_f32(lp[2]);
  const float lam = fdiv(__fsqrt_rn(3.0f), ls);
  const float ls2 = fmul(ls, ls), ls3 = fmul(ls, ls2);
  const float F[2][2] = {{0.0f, 1.0f}, {fmul(-lam, lam), fmul(-2.0f, lam)}};
  const float Pinf[2][2] = {{magn, 0.0f}, {0.0f, fmul(fmul(magn, lam), lam)}};
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      g.F[i][j] = F[i][j];
      g.Pinf[i][j] = Pinf[i][j];
#pragma unroll
      for (int p = 0; p < 3; ++p) g.dF[p][i][j] = g.dPinf[p][i][j] = 0.0f;
    }
  g.dF[2][1][0] = fdiv(6.0f, ls3);
  g.dF[2][1][1] = fdiv(fmul(2.0f, lam), ls);
  g.dPinf[1][0][0] = 1.0f;
  g.dPinf[1][1][1] = fdiv(3.0f, ls2);
  g.dPinf[2][1][1] = fdiv(fmul(-6.0f, magn), ls3);
  g.dR[0] = 1.0f;
  g.dR[1] = g.dR[2] = 0.0f;
  g.R = sigma2;

  float fdt[2][2], A[2][2], At[2][2], t[2][2], Q[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) fdt[i][j] = fmul(F[i][j], dt);
  expm(fdt, A);
  tr(A, At);
  mm3(A, Pinf, At, t);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) Q[i][j] = fsub(Pinf[i][j], t[i][j]);

  // the DARE: X <- AKB X AKB^T + (K R) K^T + Q, 100 trips
  float X[2][2] = {{1.0f, 0.0f}, {0.0f, 1.0f}};
  for (int it = 0; it < kDareIters; ++it) {
    float hx[1][2], hxh[1][1], xh[2][1], xs[2][1], K[2][1], akb[2][2], akbt[2][2], t1[2][2];
    mm(kH, X, hx);
    mm(hx, kHt, hxh);
    const float s = fadd(hxh[0][0], sigma2);
    mm(X, kHt, xh);
    xs[0][0] = fdiv(xh[0][0], s);
    xs[1][0] = fdiv(xh[1][0], s);
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
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      g.A[i][j] = A[i][j];
      g.PP[i][j] = X[i][j];
      g.AKHA[i][j] = ffma(-K[i][0], HA[0][j], A[i][j]);
    }
    g.PPH[i][0] = pph[i][0];
    g.K[i][0] = K[i][0];
    g.HA[0][i] = HA[0][i];
    g.AK[i][0] = AK[i][0];
  }
  g.S = S;
}

// thread p of 0-2: the derivatives for hyperparameter p
__device__ void gains_param(int p, float dt, Gains& g) {
  float A[2][2], At[2][2], Pinf[2][2], PP[2][2], dPinf[2][2], AK[2][1], AKt[1][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      A[i][j] = g.A[i][j];
      At[j][i] = g.A[i][j];
      Pinf[i][j] = g.Pinf[i][j];
      PP[i][j] = g.PP[i][j];
      dPinf[i][j] = g.dPinf[p][i][j];
    }
    AK[i][0] = g.AK[i][0];
    AKt[0][i] = g.AK[i][0];
  }
  const float dR = g.dR[p], S = g.S;
  float ff[4][4], aa[4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      ff[i][j] = fmul(g.F[i][j], dt);
      ff[i][j + 2] = fmul(0.0f, dt);
      ff[i + 2][j] = fmul(g.dF[p][i][j], dt);
      ff[i + 2][j + 2] = fmul(g.F[i][j], dt);
    }
  expm(ff, aa);
  float dA[2][2], dAt[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      dA[i][j] = aa[i + 2][j];
      dAt[j][i] = aa[i + 2][j];
    }
  float t1[2][2], t2[2][2], t3[2][2], dQ[2][2], C[2][2];
  mm3(dA, Pinf, At, t1);
  mm3(A, dPinf, At, t2);
  mm3(A, Pinf, dAt, t3);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) dQ[i][j] = fsub(fsub(fsub(dPinf[i][j], t1[i][j]), t2[i][j]), t3[i][j]);
  float dQs[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) dQs[i][j] = fmul(0.5f, fadd(dQ[i][j], dQ[j][i]));
  float c1[2][2], c2[2][2], dapp[2][2], u[2][1], akh[2][2], c4[2][2];
  mm(dA, PP, dapp);
  mm(dapp, At, c1);
  mm3(A, PP, dAt, c2);
  mm(dapp, kHt, u);
  mm(AK, kH, akh);
  mm3(akh, PP, dAt, c4);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float c = fadd(c1[i][j], c2[i][j]);
      c = ffma(-u[i][0], AKt[0][j], c);
      c = fsub(c, c4[i][j]);
      C[i][j] = fadd(ffma(fmul(AK[i][0], dR), AKt[0][j], c), dQs[i][j]);
    }
  float Cs[2][2], ab[2][2], abt[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      Cs[i][j] = fmul(0.5f, fadd(C[i][j], C[j][i]));
      ab[i][j] = ffma(-AK[i][0], kH[0][j], A[i][j]);
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
  float hx[1][2], hxh[1][1], xh[2][1], hda[1][2];
  mm(kH, X, hx);
  mm(hx, kHt, hxh);
  const float dS = fadd(hxh[0][0], dR);
  mm(X, kHt, xh);
  const float q = fdiv(dS, fmul(S, S));
  float dK[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) dK[i] = ffma(-g.PPH[i][0], q, fdiv(xh[i][0], S));
  mm(kH, dA, hda);
  g.dS[p] = dS;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    g.dK[p][i] = dK[i];
    g.HdA[p][i] = hda[0][i];
#pragma unroll
    for (int j = 0; j < 2; ++j)
      g.dAKHA[p][i][j] = ffma(-g.K[i][0], hda[0][j], ffma(-dK[i], g.HA[0][j], dA[i][j]));
  }
}

__global__ void __launch_bounds__(kThreads)
learning_kernel(const float* __restrict__ log_params, const float* __restrict__ y,
                const uint8_t* __restrict__ mask, int B, int T, float dt, float lr_magn,
                float lr_ls, float* __restrict__ scratch, float* __restrict__ new_params,
                float* __restrict__ nll_out) {
  __shared__ Gains g;
  __shared__ float lp[3];
  __shared__ int counts[kThreads];
  const int a = blockIdx.x, t = threadIdx.x;
  if (t < 3) lp[t] = log_params[a * 3 + t];
  __syncthreads();
  if (t == 0) gains_base(lp, dt, g);
  __syncthreads();
  if (t < 3) gains_param(t, dt, g);
  __syncthreads();

  // stage 2: one thread per window
  const int n_chunks = (B + kChunk - 1) / kChunk;
  float* vals = scratch + (size_t)a * (B + n_chunks) * 4;
  float* chunks = vals + (size_t)B * 4;
  {
    float AKHA[2][2], K[2], HA[2], dS[3], dK[3][2], dAKHA[3][2][2], HdA[3][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      K[i] = g.K[i][0];
      HA[i] = g.HA[0][i];
#pragma unroll
      for (int j = 0; j < 2; ++j) AKHA[i][j] = g.AKHA[i][j];
    }
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      dS[p] = g.dS[p];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        dK[p][i] = g.dK[p][i];
        HdA[p][i] = g.HdA[p][i];
#pragma unroll
        for (int j = 0; j < 2; ++j) dAKHA[p][i][j] = g.dAKHA[p][i][j];
      }
    }
    const float S = g.S;
    const float hl2pi = fmul(0.5f, log_f32(6.283185308f));
    const float hlS = fmul(0.5f, log_f32(S));
    const float SS = fmul(S, S);
    int count = 0;
    for (int b = t; b < B; b += kThreads) {
      const float* yy = y + ((size_t)a * B + b) * T;
      float m0 = 0.0f, m1 = 0.0f, e = 0.0f, gd[3] = {0.0f, 0.0f, 0.0f};
      float dm[3][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f}};
      for (int k = 0; k < T; ++k) {
        const float yk = yy[k];
        const float v = fsub(yk, ffma(HA[1], m1, fmul(HA[0], m0)));
        const float vv = fmul(fmul(0.5f, v), v);
        e = fadd(fadd(fadd(e, fdiv(vv, S)), hl2pi), hlS);
        float ndm[3][2];
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          const float hm = ffma(HdA[p][1], m1, fmul(HdA[p][0], m0));
          const float dmh = ffma(dm[p][1], HA[1], fmul(dm[p][0], HA[0]));
          const float dv = fsub(-hm, dmh);
          gd[p] = fadd(fsub(fadd(gd[p], fdiv(fmul(v, dv), S)), fdiv(fmul(vv, dS[p]), SS)),
                      fdiv(fmul(0.5f, dS[p]), S));
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float dam = ffma(dAKHA[p][i][1], m1, fmul(dAKHA[p][i][0], m0));
            const float dma = ffma(dm[p][1], AKHA[i][1], fmul(dm[p][0], AKHA[i][0]));
            ndm[p][i] = ffma(dK[p][i], yk, fadd(dam, dma));
          }
        }
        const float n0 = ffma(K[0], yk, ffma(AKHA[0][1], m1, fmul(AKHA[0][0], m0)));
        const float n1 = ffma(K[1], yk, ffma(AKHA[1][1], m1, fmul(AKHA[1][0], m0)));
        m0 = n0;
        m1 = n1;
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          dm[p][0] = ndm[p][0];
          dm[p][1] = ndm[p][1];
        }
      }
      const bool on = mask[(size_t)a * B + b] != 0;
      const float w = on ? 1.0f : 0.0f;
      count += on ? 1 : 0;
      float* out = vals + (size_t)b * 4;
      out[0] = fmul(e, w);
      out[1] = fmul(gd[0], w);
      out[2] = fmul(gd[1], w);
      out[3] = fmul(gd[2], w);
    }
    counts[t] = count;
  }
  __syncthreads();

  // stage 3: the chunk sums, then their sum and the update
  for (int c = t; c < n_chunks; c += kThreads) {
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const int end = min(B, (c + 1) * kChunk);
    for (int b = c * kChunk; b < end; ++b)
#pragma unroll
      for (int q = 0; q < 4; ++q) s[q] = fadd(s[q], vals[(size_t)b * 4 + q]);
#pragma unroll
    for (int q = 0; q < 4; ++q) chunks[(size_t)c * 4 + q] = s[q];
  }
  __syncthreads();
  if (t == 0) {
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int c = 0; c < n_chunks; ++c)
#pragma unroll
      for (int q = 0; q < 4; ++q) s[q] = fadd(s[q], chunks[(size_t)c * 4 + q]);
    long long n_on = 0;
    for (int i = 0; i < kThreads; ++i) n_on += counts[i];
    const float denom = fmaxf((float)n_on, 1.0f);
    nll_out[a] = fdiv(s[0], denom);
    float nw[3];
    nw[0] = lp[0];
    nw[1] = ffma(-lr_magn, fmul(exp_f32(lp[1]), fdiv(s[2], denom)), lp[1]);
    nw[2] = ffma(-lr_ls, fmul(exp_f32(lp[2]), fdiv(s[3], denom)), lp[2]);
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      float x = nw[p];
      if (!isnan(x)) x = fminf(fmaxf(x, -10.0f), 10.0f);
      new_params[a * 3 + p] = isfinite(x) ? x : 0.0f;
    }
  }
}

}  // namespace

// A problems: log_params (A, 3) f32, y (A, B, T) f32 mean-centred windows,
// mask (A, B) u8; scratch (A, B + ceil(B / 32), 4) f32 (the per-window
// values and the chunk sums; no need to zero it).  Outputs new_params (A, 3)
// and nll (A,) f32.  A >= 1, 1 <= B <= 2^24 (the mask count stays exact in
// f32), T >= 1.
extern "C" int motl_learning_step(const float* log_params, const float* y, const uint8_t* mask,
                                  int A, int B, int T, float dt, float lr_magn, float lr_ls,
                                  float* scratch, float* new_params, float* nll, void* stream) {
  if (A < 1 || B < 1 || B > (1 << 24) || T < 1) return (int)cudaErrorInvalidValue;
  learning_kernel<<<A, kThreads, 0, (cudaStream_t)stream>>>(log_params, y, mask, B, T, dt,
                                                             lr_magn, lr_ls, scratch,
                                                             new_params, nll);
  return (int)cudaGetLastError();
}
