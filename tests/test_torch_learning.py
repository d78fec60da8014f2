"""The port's learning step (``models/learning.py``, ``models/f32_math.py``,
the learning half of ``models/ihgp.py``) against the JAX package on the
CPU, and K13's source (``csrc/learning.cu``) compiled for the host against
its plain version.

Inputs are f32 numpy from a seed on both sides.  The JAX functions run
under ``jax.jit`` with the gains as arguments, as ``learning_step`` computes
them (closure constants would let XLA fold divisions into reciprocals).
The port spells XLA's CPU arithmetic -- its exp and log polynomials, its
dots as FMA chains, the multiply-adds it fuses, LAPACK's getf2 + trsm for
``jnp.linalg.solve``, ``x / S / S`` as ``x / (S * S)`` -- and on the x86
host these spellings were found on, the learning step's comparisons below
are bit for bit (the scans, on no path, agree to a few ulp).  The
tolerances stated are wider, because XLA's code generation (vectorized
reductions, FMA contraction) may vary with the host CPU:

- the model, the gains, the window recursion and the scans: 1e-6
  relative to each field's largest entry;
- expm: 2.4e-7 x 2**s relative to the largest entry at s squarings (each
  squaring doubles a last-bit difference of the Pade result);
- ``learning_step``: 10 steps, the log-parameters within 1e-6 absolute and
  the NLL within 1e-6 relative (the masked sums past 32 windows reduce in
  another order than XLA's vectorized one).

The host-compiled K13 (a shim maps the CUDA intrinsics to IEEE host
arithmetic, ``std::fmaf`` and one std::thread per CUDA thread) must equal
``learning_step_plain`` bit for bit; it skips where no host C++ compiler
exists.
"""

import ctypes
import os
import re
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.linalg import expm as jexpm

from multiple_object_tracking_lidar_tpu.models import learning as JL
from multiple_object_tracking_lidar_tpu.models.ihgp import ihgp_batch as j_batch
from multiple_object_tracking_lidar_tpu.models.ihgp import ihgp_filter_smoother as j_fs
from multiple_object_tracking_lidar_tpu.models.ihgp import ihgp_nll_grad as j_nll_grad
from multiple_object_tracking_lidar_tpu_torch import models as tmodels
from multiple_object_tracking_lidar_tpu_torch.models import learning as TL
from multiple_object_tracking_lidar_tpu_torch.models.f32_math import exp_f32, log_f32
from multiple_object_tracking_lidar_tpu_torch.models.ihgp import ihgp_nll_grad, stationary_gains
from multiple_object_tracking_lidar_tpu_torch.models.matern32 import matern32_from_log
from multiple_object_tracking_lidar_tpu_torch.ops import learning_cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_REL = 1e-6
TOL_LP, TOL_NLL = 1e-6, 1e-6
DT = 0.1


def _close(got, ref, tol=TOL_REL):
    """|got - ref| <= tol * max|ref|, NaN where ref is NaN."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    fin = ~np.isnan(ref)
    scale = np.max(np.abs(ref[fin]), initial=0.0)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=0, atol=tol * scale)


def _log_params(rng, n):
    return np.stack([rng.uniform(-7, -3, n), rng.uniform(-5, 0, n),
                     rng.uniform(-1, 3, n)], -1).astype(np.float32)


def _windows(rng, b, t):
    """Mean-centred velocity-like windows: noisy sinusoids."""
    s = np.arange(t + 1) * DT
    v = np.stack([0.5 * np.sin(s * rng.uniform(0.5, 2)) + rng.normal(0, 0.05, t + 1)
                  for _ in range(b)])[:, 1:]
    return (v - v.mean(1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def jit_gains():
    return jax.jit(jax.vmap(lambda lp: JL.stationary_gains_jax(lp, DT)))


def test_exp_log_f32_match_xla():
    """models/f32_math.py against jnp.exp / jnp.log under jit: exp on
    [-104, 88.37] and its edges, log on positive normals, 0, subnormal,
    negative, inf and NaN inputs."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-104, 88.37, 20000), rng.normal(0, 1e-3, 2000),
                        [0.0, -0.0, -np.inf, np.nan, -10.0, 10.0]]).astype(np.float32)
    _close(exp_f32(torch.from_numpy(x)), jax.jit(jnp.exp)(x))
    y = np.concatenate([np.exp(rng.uniform(-87, 88.7, 20000)),
                        [0.0, -1.0, 1e-40, 1.17549435e-38, 1.0, 2.0, 6.283185308, np.inf,
                         np.nan]]).astype(np.float32)
    got, ref = log_f32(torch.from_numpy(y)).numpy(), np.asarray(jax.jit(jnp.log)(y))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    fin = np.isfinite(ref)
    _close(got[fin], ref[fin])


def test_matern32_torch_matches_jax():
    lp = _log_params(np.random.default_rng(1), 64)
    ref = jax.jit(jax.vmap(JL.matern32_jax))(lp)
    got = TL.matern32_torch(torch.from_numpy(lp))
    for k in ref:
        _close(got[k], ref[k])


def _expm_inputs(rng, n, norm):
    """Upper-triangular f32 matrices of 1-norm ``norm`` plus a diagonal in
    [-1, 0.5]: well conditioned at every scaling."""
    a = np.triu(rng.uniform(-1, 1, (16, n, n)), 1)
    a = a / np.abs(a).sum(1).max(-1)[:, None, None] * norm
    return (a + np.eye(n) * rng.uniform(-1, 0.5, (16, 1, n))).astype(np.float32)


@pytest.mark.parametrize("n", [2, 4])
def test_expm_f32_matches_jax(n):
    """Pade 3 (norm 0.1), 5 (1.0) and 7 (3.0) without squarings, 1-16
    squarings, and past 16 (NaN); and the model's own F dt and Van Loan
    blocks at logLengthScale in [-1, 10]."""
    rng = np.random.default_rng(n)
    jx = jax.jit(jax.vmap(jexpm))
    for s, norm in [(0, 0.1), (0, 1.0), (0, 3.0)] + [
            (s, TL.EXPM_MAXNORM * 2 ** s * 1.4) for s in range(1, 18)]:
        a = _expm_inputs(rng, n, norm)
        ref = np.asarray(jx(a))
        got = TL.expm_f32(torch.from_numpy(a)).numpy()
        if s > 16:
            assert np.isnan(ref).all() and np.isnan(got).all()
        else:
            _close(got, ref, 2.4e-7 * 2 ** s)
    lp = np.stack([np.full(64, -5.5), np.full(64, -3.5), np.linspace(-1, 10, 64)],
                  -1).astype(np.float32)
    ssm = TL.matern32_torch(torch.from_numpy(lp))
    F = ssm["F"]
    if n == 2:
        a = (F * torch.tensor(DT)).numpy()
    else:
        dF = ssm["dF"][:, 2]
        a = (torch.cat([torch.cat([F, torch.zeros_like(F)], -1), torch.cat([dF, F], -1)], -2)
             * torch.tensor(DT)).numpy()
    _close(TL.expm_f32(torch.from_numpy(a)), jx(a))


def test_stationary_gains_torch_matches_jax_and_host(jit_gains):
    """Against the jitted stationary_gains_jax (1e-6 of each field's
    largest entry) and against the host f64 stationary_gains and its
    derivatives (1e-3: the f32 expm and DARE against f64, up to 1.2e-4
    seen)."""
    lp = _log_params(np.random.default_rng(2), 32)
    ref = jit_gains(lp)
    got = TL.stationary_gains_torch(torch.from_numpy(lp), DT)
    for k in ref:
        _close(got[k], ref[k])
    for i in range(0, 32, 8):
        host = stationary_gains(matern32_from_log(*[float(v) for v in lp[i]]), DT)
        for k in ("A", "K", "HA", "AKHA", "G", "S", "dS", "dK", "dAKHA", "HdA"):
            _close(got[k][i], getattr(host, k), 1e-3)


def test_ihgp_nll_grad_matches_jax(jit_gains):
    """The window recursion over 64 windows of 1, 2, 5 and 39 steps from
    m0 = 0 and from a random m0, the gains passed as arguments."""
    rng = np.random.default_rng(3)
    lp = _log_params(rng, 1)
    g = {k: np.array(v[0]) for k, v in jit_gains(lp).items()}
    gt = {k: torch.from_numpy(v) for k, v in g.items()}
    f = jax.jit(lambda y, m0, g: jax.vmap(lambda yy, mm: j_nll_grad(yy, mm, g))(y, m0))
    for t in (1, 2, 5, 39):
        y = rng.normal(0, 0.3, (64, t)).astype(np.float32)
        m0 = rng.normal(0, 0.1, (64, 2)).astype(np.float32) * (t > 2)
        e, gr = f(y, m0, g)
        et, grt = ihgp_nll_grad(torch.from_numpy(y), torch.from_numpy(m0), gt)
        _close(et, e)
        _close(grt, gr)


def test_ihgp_scans_match_jax():
    """ihgp_filter_smoother on one window and ihgp_batch on a (K, 2, L)
    bank, with the host gains' ``as_arrays`` (and ``as_arrays_learning``
    holding the JAX ``as_jax_learning`` set); both exported as in the JAX
    models package."""
    rng = np.random.default_rng(4)
    gx = stationary_gains(matern32_from_log(-5.5, -3.5, 0.75), DT)
    gy = stationary_gains(matern32_from_log(-5.0, -3.0, 0.5), DT)
    ax, ay = gx.as_arrays(), gy.as_arrays()
    from multiple_object_tracking_lidar_tpu.models.ihgp import stationary_gains as j_sg
    from multiple_object_tracking_lidar_tpu.models.matern32 import matern32_from_log as j_m

    jl = j_sg(j_m(-5.5, -3.5, 0.75), DT).as_jax_learning()
    tl = gx.as_arrays_learning()
    assert set(tl) == set(jl)
    for k in jl:
        np.testing.assert_array_equal(tl[k], jl[k])
    y = rng.normal(0, 0.3, 12).astype(np.float32)
    m0 = rng.normal(0, 0.1, 2).astype(np.float32)
    ref = jax.jit(j_fs)(y, m0, ax)
    got = tmodels.ihgp_filter_smoother(y, m0, ax, device="cpu")
    for g_, r_ in zip(got, ref):
        _close(g_, r_)
    gxy = {k: np.stack([ax[k], ay[k]]) for k in ax}
    yb = rng.normal(0, 0.3, (5, 2, 12)).astype(np.float32)
    mb = rng.normal(0, 0.1, (5, 2, 2)).astype(np.float32)
    ref = jax.jit(j_batch)(yb, mb, gxy)
    got = tmodels.ihgp_batch(yb, mb, gxy, device="cpu")
    for g_, r_ in zip(got, ref):
        assert g_.shape == r_.shape
        _close(g_, r_)


def _steps(lp, y, mask, dt, n=10):
    """n steps of the JAX learning_step and the port's, side by side."""
    lj, lt = jnp.asarray(lp), torch.from_numpy(lp)
    out = []
    for _ in range(n):
        lj, nj = JL.learning_step(lj, jnp.asarray(y), jnp.asarray(mask), dt)
        lt, nt = TL.learning_step(lt, torch.from_numpy(y), torch.from_numpy(mask), dt)
        out.append((np.asarray(lj), float(nj), lt.numpy(), float(nt)))
    return out


@pytest.mark.parametrize("b,t,dt", [(8, 5, 0.1), (64, 39, 0.1), (40, 9, 0.125)])
def test_learning_step_matches_jax(b, t, dt):
    """10 SGD steps from the config's log-parameters, a third of the
    windows masked out."""
    rng = np.random.default_rng(b)
    y = _windows(rng, b, t)
    mask = np.ones(b, bool)
    mask[::3] = False
    lp = np.asarray([-5.5, -3.5, 0.75], np.float32)
    for lj, nj, lt, nt in _steps(lp, y, mask, dt):
        assert lt.dtype == np.float32 and lt[0] == lp[0]          # sigma2 frozen
        np.testing.assert_allclose(lt, lj, rtol=0, atol=TOL_LP)
        np.testing.assert_allclose(nt, nj, rtol=TOL_NLL)


@pytest.mark.parametrize("lls", [-10.0, 10.0])
def test_learning_step_edges_match_jax(lls):
    """logLengthScale at -10 takes the NaN path (expm past 16 squarings):
    NaN NLL, entries 1 and 2 reset to 0 (exp(0) = 1), sigma2 kept; at +10
    the step (theta = e^10 times the gradient) overshoots and the clamp
    holds it at -10."""
    rng = np.random.default_rng(5)
    y = _windows(rng, 8, 5)
    lp = np.asarray([-5.5, -3.5, lls], np.float32)
    lj, nj, lt, nt = _steps(lp, y, np.ones(8, bool), DT, n=1)[0]
    np.testing.assert_allclose(lt, lj, rtol=0, atol=TOL_LP)
    if lls < 0:
        assert np.isnan(nj) and np.isnan(nt)
        np.testing.assert_array_equal(lt, [-5.5, 0.0, 0.0])
    else:
        np.testing.assert_allclose(nt, nj, rtol=TOL_NLL)
        assert lt[2] == -10.0


def test_learning_step_stacked_is_each_problem():
    """learning_step_stacked on A = 3 problems (the node stacks x and y)
    is each problem's learning_step, bit for bit."""
    rng = np.random.default_rng(6)
    lp = torch.from_numpy(_log_params(rng, 3))
    y = torch.from_numpy(np.stack([_windows(rng, 7, 9) for _ in range(3)]))
    mask = torch.from_numpy(rng.uniform(size=(3, 7)) > 0.3)
    new, nll = TL.learning_step_stacked(lp, y, mask, DT)
    for i in range(3):
        n1, l1 = TL.learning_step(lp[i], y[i], mask[i], DT)
        assert torch.equal(new[i], n1) and torch.equal(nll[i], l1)


def test_k13_wrapper_raises_off_the_card_and_past_its_bounds():
    """K13's wrapper takes CUDA f32 tensors of consistent shapes within
    its bounds and raises ValueError otherwise (before any launch)."""
    lp, y, m = torch.zeros(2, 3), torch.zeros(2, 4, 5), torch.ones(2, 4, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        learning_cuda.learning_step_cuda(lp, y, m, DT)
    for args in ((lp, torch.zeros(2, 0, 5), torch.ones(2, 0, dtype=torch.bool)),
                 (lp, torch.zeros(2, 4, 0), m),
                 (torch.zeros(3, 3), y, m),
                 (lp, y[0], m[0])):
        with pytest.raises(ValueError, match="K13"):
            learning_cuda.learning_step_cuda(*args, DT)
    assert learning_cuda.MAX_WINDOWS >= 65536


# ---------------------------------------------------------------------------
# K13's source on the host
# ---------------------------------------------------------------------------

SHIM = r"""
#include <atomic>
#include <cmath>
#include <barrier>
#include <thread>
#include <vector>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <algorithm>
using std::min; using std::max;
#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__
#define __shared__ static
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
thread_local dim3 threadIdx, blockIdx;
dim3 gridDim;
std::barrier<>* g_bar;
inline void __syncthreads() { g_bar->arrive_and_wait(); }
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  const unsigned long long o = *p;
  *p = o + v;
  return o;
}
inline float __ldcg(const float* p) { return *p; }
// a whole warp's shuffles and ballot: each lane posts its value, the 32
// lanes meet at the warp's barrier, read, and meet again
struct WarpSync { std::barrier<> all{32}; float x[32]; };
WarpSync* g_warps;
inline float shfl_(unsigned mask, float v, int src) {
  if (mask != 0xffffffffu) std::abort();
  WarpSync& s = g_warps[threadIdx.x / 32];
  s.x[threadIdx.x % 32] = v;
  s.all.arrive_and_wait();
  const float r = s.x[src];
  s.all.arrive_and_wait();
  return r;
}
inline float __shfl_xor_sync(unsigned mask, float v, int m) {
  return shfl_(mask, v, (int)(threadIdx.x % 32) ^ m);
}
inline float __shfl_sync(unsigned mask, float v, int src) { return shfl_(mask, v, src); }
inline unsigned __ballot_sync(unsigned mask, bool p) {
  if (mask != 0xffffffffu) std::abort();
  WarpSync& s = g_warps[threadIdx.x / 32];
  s.x[threadIdx.x % 32] = p ? 1.0f : 0.0f;
  s.all.arrive_and_wait();
  unsigned bits = 0;
  for (int l = 0; l < 32; ++l)
    if (s.x[l] != 0.0f) bits |= 1u << l;
  s.all.arrive_and_wait();
  return bits;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fmaf_rn(float a, float b, float c) { return std::fmaf(a, b, c); }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
inline int __float_as_int(float f) { int i; std::memcpy(&i, &f, 4); return i; }
typedef void* cudaStream_t;
enum { cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }
// The CTAs run one after another, problem by problem; the windows' CTAs in
// ascending order for even problems and descending for odd ones, so either
// end of a problem's CTAs is the last to arrive and takes the ticket.  The
// block's threads are std::threads that run every CTA in turn, meeting at
// one barrier (and each warp's lanes at their shuffles).
#define LAUNCH(kernel, grid, block, ...) do { \
  gridDim = (grid); \
  std::barrier<> bar(block); g_bar = &bar; \
  std::vector<WarpSync> warps((block) / 32); g_warps = warps.data(); \
  std::vector<std::thread> ts; \
  for (int t_ = 0; t_ < (block); ++t_) \
    ts.emplace_back([&, t_] { \
      threadIdx = dim3(t_); \
      for (unsigned y_ = 0; y_ < gridDim.y; ++y_) \
        for (unsigned i_ = 0; i_ < gridDim.x; ++i_) { \
          blockIdx = dim3(y_ % 2 ? gridDim.x - 1 - i_ : i_, y_); \
          kernel(__VA_ARGS__); \
          bar.arrive_and_wait(); \
        } \
    }); \
  for (auto& th : ts) th.join(); } while (0)
"""


@pytest.fixture(scope="module")
def k13_host(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build K13's source for the host")
    src = open(os.path.join(REPO, "multiple_object_tracking_lidar_tpu_torch", "csrc",
                            "learning.cu")).read()
    assert int(re.search(r"constexpr int kW = (\d+);", src).group(1)) == W
    src = src.replace("#include <cuda_runtime.h>", '#include "shim.h"')
    src, n = re.subn(r"learning_kernel<<<grid, kThreads, 0, \(cudaStream_t\)stream>>>\(",
                     "LAUNCH(learning_kernel, grid, kThreads, ", src)
    assert n == 1
    d = tmp_path_factory.mktemp("k13")
    (d / "shim.h").write_text(SHIM)
    (d / "k13.cpp").write_text(src)
    so = str(d / "libk13.so")
    subprocess.run([cxx, "-O1", "-ffp-contract=off", "-std=c++20", "-pthread", "-fPIC",
                    "-shared", "-o", so, str(d / "k13.cpp")], check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.motl_learning_step.argtypes = [P, P, P, I, I, I, F, F, F, P, P, P, P, P]
    return lib


W = learning_cuda.WINDOWS_PER_CTA
# (label, A, B, T, dt, mask): "drawn" draws 60% of the windows on (window 0
# always), "cta off" turns the second CTA's windows off (W to 2W), "chunk
# off" the second 32-window chunk, "problem off" every window of problem 0.
# B <= W is one CTA; past it CTAs of W windows and the ticket.
K13_HOST_CASES = [
    ("node", 2, 3, 39, 0.1, "drawn"),
    ("tune", 1, 60, 9, 0.1, "drawn"),
    ("B = 300", 2, 300, 5, 0.125, "drawn"),
    ("edges, T = 1", 3, 33, 1, 0.1, "drawn"),
    ("one window", 1, 1, 39, 0.1, "drawn"),
    ("W - 1", 2, W - 1, 7, 0.1, "drawn"),
    ("W", 1, W, 7, 0.1, "drawn"),
    ("W + 1", 2, W + 1, 7, 0.1, "drawn"),
    ("2W", 1, 2 * W, 7, 0.1, "drawn"),
    ("2W + 1", 2, 2 * W + 1, 7, 0.1, "drawn"),
    ("2W + 33", 2, 2 * W + 33, 6, 0.1, "drawn"),
    ("a CTA off", 2, 2 * W + 33, 6, 0.1, "cta off"),
    ("a chunk off", 1, 2 * W - 2, 5, 0.1, "chunk off"),
    ("a problem off", 2, 3 * W + 4, 4, 0.1, "problem off"),
    ("T = 1, CTAs", 2, 3 * W + 2, 1, 0.1, "drawn"),
    ("T past a y block", 1, W - 6, 150, 0.1, "drawn"),
    ("T past a y block, CTAs", 2, 2 * W + 6, 90, 0.1, "drawn"),
]


@pytest.mark.parametrize("label,a,b,t,dt,mask", K13_HOST_CASES,
                         ids=[c[0] for c in K13_HOST_CASES])
def test_k13_source_on_the_host_matches_plain(k13_host, label, a, b, t, dt, mask):
    """K13's source with IEEE host arithmetic equals learning_step_plain
    bit for bit: the node's (2, 3, 39) and tune's (1, 60, 9) shapes, B past
    256, one step per window with logLengthScale at -10 (NaN, reset) and
    +10, one window; the split over CTAs of ``W`` windows at B = W - 1, W,
    W + 1 and 2W + 33, a CTA, a 32-window chunk and a whole problem masked
    off, T = 1 over several CTAs, and T past one shared-memory block of
    y (the last two problems ride on several CTAs' tickets)."""
    rng = np.random.default_rng(7 + [c[0] for c in K13_HOST_CASES].index(label))
    lp = _log_params(rng, a)
    if label.startswith("edges"):
        lp[1, 2], lp[2, 2] = -10.0, 10.0
    y = rng.normal(0, 0.3, (a, b, t)).astype(np.float32)
    m = (rng.uniform(size=(a, b)) > 0.4).astype(np.uint8)
    m[:, 0] = 1
    if mask == "cta off":
        m[:, W:2 * W] = 0
    elif mask == "chunk off":
        m[:, 32:64] = 0
    elif mask == "problem off":
        m[0] = 0
    chunk_sums = np.zeros((a, -(-b // TL.SUM_CHUNK), 4), np.float32)
    tickets = np.zeros(a, np.uint64)
    new, nll = np.zeros((a, 3), np.float32), np.zeros(a, np.float32)
    err = k13_host.motl_learning_step(lp.ctypes.data, y.ctypes.data, m.ctypes.data, a, b, t,
                                      dt, 0.1, 0.01, chunk_sums.ctypes.data,
                                      tickets.ctypes.data, new.ctypes.data, nll.ctypes.data,
                                      None)
    assert err == 0
    assert not tickets.any()                           # left zero for the next launch
    pn, pl = TL.learning_step_plain(torch.from_numpy(lp), torch.from_numpy(y),
                                    torch.from_numpy(m.astype(bool)), dt)
    np.testing.assert_array_equal(new.view(np.uint32), pn.numpy().view(np.uint32))
    np.testing.assert_array_equal(nll.view(np.uint32), pl.numpy().view(np.uint32))
