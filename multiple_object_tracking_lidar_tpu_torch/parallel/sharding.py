"""Fleet tracking over a torch.distributed DeviceMesh.

Port of ``multiple_object_tracking_lidar_tpu/parallel/sharding.py``.  Two
mesh axes, ("stream", "space"):

* **stream** -- independent LiDAR streams are a leading batch axis; the
  streams split over the stream axis with no communication.
* **space** -- one cloud's points split over the space axis.  Voxel
  accumulation is additive over points, so each rank accumulates its point
  shard into the small dense grid and one all-reduce over the space group
  rebuilds the global grid; the rest of the step runs replicated.

The JAX package runs one ``shard_map`` program over the mesh.  Here each
rank runs the same code on its own shard, as torch SPMD code does: stream
rows (B / n_stream, ...) and, of each, points (N / n_space, 3)
(``local_shard`` cuts a global array the same way).  Two per-rank forms,
chosen as the JAX package chooses them (sharding.py:88-107):

* **kernel fleet** (``voxel_mode="onehot"`` + ``cluster_backend="grid"``):
  the local point shard padded to a multiple of 512 with masked rows, K1's
  or K5's histogram alone at any grid size (``voxel_grid.digit_sums_stacked``),
  ``all_reduce`` of the int32 digit sums and of the point counts over the
  space group --
  exactly two collectives, and the integer sums make the result the same
  bits at every space factor -- one finalize, then the dense grid's
  stacked perception over the local streams (K2, the batched cluster
  table, one K3f launch) and one K4 launch for every local stream's track
  step (``track_batch`` at B x 1, one CTA per stream).  Exact mode at
  a leaf too coarse for two digits accumulates the bf16x3 sums (K6) and
  all-reduces them in f32 (sharding.py:210-226).
* **vmap fleet** (every other config, and every f64 one, as in JAX): the
  scatter sums in the compute dtype (K6's f32 mode, or its double build
  K6f f64) whatever ``voxel_mode`` says, an all-reduce in that dtype, and
  perception from the accumulator with no per-cell static table -- on a
  grid config the stencil CC (K14, built for f32, f64, bf16 and f16
  centroids) with the per-point map lookup, since the JAX program's map is
  a tracer there (sharding.py:316-333); every config runs on the card in
  every compute dtype.
  The track step is the same
  B x 1 K4 launch, whose decisions equal the jnp associator the JAX vmap
  fleet pins; an explicit ``assoc_backend="pallas"`` raises, as it does
  there.

Under ``dtype="bfloat16"`` or ``"float16"`` the fleet is the vmap fleet,
as in JAX (its kernel fleet needs f32): the points cast to the half dtype,
K6f's half build summing them (every add rounded), the half sums summed
over the space group as XLA's CPU all-reduce sums them (``half_psum``),
then the half perception and the half track step under either
association.

Collectives go through ``torch.distributed`` on the mesh's process groups:
NCCL on the card, gloo on the CPU.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from multiple_object_tracking_lidar_tpu_torch.ops.centroid_cuda import mesh_program
from multiple_object_tracking_lidar_tpu_torch.ops.static_mask import MapEnv
from multiple_object_tracking_lidar_tpu_torch.ops.track_cuda import TrackOutputs
from multiple_object_tracking_lidar_tpu_torch.ops.voxel import voxel_accumulate_stacked
from multiple_object_tracking_lidar_tpu_torch.ops.voxel_grid import (
    _v3_leaf_ok,
    digit_sums_stacked,
    voxel_accumulate_stacked as onehot_accumulate_stacked,
)
from multiple_object_tracking_lidar_tpu_torch.ops.voxel_grid_cuda import (
    finalize_exact_stacked,
    finalize_fast_stacked,
)
from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import (
    GridPlan,
    Perception,
    Tracker,
    _frame_output,
    _perceive_batch_from_dense_acc,
    perceive_from_acc_stacked,
    resolve_device,
    track_batch,
)
from multiple_object_tracking_lidar_tpu_torch.tracker.state import TrackerState

PAD_TO = 512  # the kernel fleet pads each local point shard to this multiple


def make_mesh(n_stream: int, n_space: int = 1, device: torch.device | str = "cuda") -> DeviceMesh:
    """A ("stream", "space") DeviceMesh of n_stream x n_space ranks over the
    default process group: NCCL on the card, gloo on the CPU.  At one rank
    an uninitialised process group is created here on an in-process store
    (no network); more ranks need ``init_process_group`` first, with its
    address, world size and rank."""
    dev = resolve_device(device)
    n = n_stream * n_space
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(
                f"a {n_stream} x {n_space} mesh needs torch.distributed initialised "
                f"with {n} ranks (init_process_group with its address, world size "
                "and rank)"
            )
        backend = "nccl" if dev.type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    if dist.get_world_size() != n:
        raise ValueError(f"need {n} ranks, have {dist.get_world_size()}")
    return DeviceMesh(dev.type, torch.arange(n).reshape(n_stream, n_space),
                      mesh_dim_names=("stream", "space"))


def local_shard(a, mesh: DeviceMesh):
    """This rank's shard of a global fleet array: axis 0 (streams) cut over
    "stream" and, for arrays with a point axis, axis 1 cut over "space"."""
    n_stream, n_space = mesh.shape
    i, j = mesh.get_local_rank("stream"), mesh.get_local_rank("space")
    b = a.shape[0] // n_stream
    a = a[i * b:(i + 1) * b]
    if a.ndim > 1:
        n = a.shape[1] // n_space
        a = a[:, j * n:(j + 1) * n]
    return a


def half_psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the bf16 / f16 tensor ``x`` over the ranks of ``group``,
    as XLA's CPU all-reduce of the JAX ``psum`` computes it (read from the
    fleet program's HLO and checked on its in-process collectives): bf16
    promoted to f32 (``to_apply=%region_*_promoted``), summed in f32 in
    rank order and rounded once; f16 summed natively in rank order, each
    add rounded to f16.  One rank is the identity.  NCCL's ring and gloo
    add in other orders, so each rank gathers every rank's bits (as bytes,
    which every backend moves) and adds them in rank order itself."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    flat = x.contiguous().view(torch.uint8)
    parts = [torch.empty_like(flat) for _ in range(n)]
    dist.all_gather(parts, flat, group=group)
    vals = [p.view(x.dtype).view(x.shape) for p in parts]
    if x.dtype == torch.float16:
        acc = vals[0]
        for v in vals[1:]:
            acc = acc + v
        return acc
    acc = vals[0].float()
    for v in vals[1:]:
        acc = acc + v.float()
    return acc.to(x.dtype)


@dataclasses.dataclass
class ShardedTracker:
    """Fleet tracking: a batch of independent streams over a DeviceMesh,
    optionally with each stream's points split over the space axis.

    ``kernel_path``: "auto" (kernel fleet when the config runs the
    onehot + grid pipeline, vmap fleet otherwise) | "on" (require the
    kernel fleet -- raises if the config cannot run it) | "off" (always the
    vmap fleet)."""

    tracker: Tracker
    mesh: DeviceMesh
    kernel_path: str = "auto"

    def __post_init__(self):
        if self.kernel_path not in ("auto", "on", "off"):
            raise ValueError(f"unknown kernel_path {self.kernel_path!r}")
        cfg = self.tracker.config
        kernel_ok = (
            cfg.voxel_mode == "onehot"
            and cfg.cluster_backend == "grid"
            and cfg.dtype == "float32"
        )
        if self.kernel_path == "on" and not kernel_ok:
            raise ValueError(
                "kernel_path='on' needs voxel_mode='onehot', "
                "cluster_backend='grid', dtype=float32 (got "
                f"{cfg.voxel_mode!r}/{cfg.cluster_backend!r}/{cfg.dtype!r})"
            )
        self._use_kernel_fleet = kernel_ok and self.kernel_path != "off"
        if not self._use_kernel_fleet and cfg.assoc_backend == "pallas":
            raise ValueError(
                "assoc_backend='pallas' cannot run under the vmap fleet "
                "(ShardedTracker kernel_path='off'/non-grid config); use "
                "'auto'/'jnp', or the onehot+grid config for the kernel fleet"
            )
        if self.mesh.device_type != self.tracker.device.type:
            raise ValueError(
                f"mesh on {self.mesh.device_type!r}, tracker on {self.tracker.device.type!r}"
            )
        self.n_stream, self.n_space = self.mesh.shape
        self._space = self.mesh.get_group("space")

    def init_state(self, batch: int) -> TrackerState:
        """The stacked state rows of this rank's streams, in a fleet of
        ``batch`` streams."""
        if batch % self.n_stream:
            raise ValueError(f"batch {batch} does not split over {self.n_stream} stream ranks")
        return self.tracker.init_state(batch=batch // self.n_stream)

    def plan(self, env: MapEnv) -> GridPlan:
        """The map on the device: with its per-cell static table for the
        kernel fleet (which needs one), without for the vmap fleet."""
        if not self._use_kernel_fleet:
            return self.tracker.plan(env, cell_table=False)
        plan = self.tracker.plan(env)
        if plan.table is None:
            raise ValueError(
                "kernel fleet needs a map with a per-cell static table; this "
                "map's cell window passes 32 bits (a rotated or coarse map)"
            )
        return plan

    def bind_env(self, env: MapEnv):
        """Plan the map once and return ``step(state, points, mask, t)``."""
        plan = self.plan(env)
        return lambda state, points, mask, t: self._step(state, points, mask, t, plan)

    def step(self, state: TrackerState, points, mask, t, env: MapEnv):
        """This rank's shard: points (B / n_stream, N / n_space, 3), mask
        (B / n_stream, N / n_space), t (B / n_stream,).  Returns (state,
        outputs stacked over the local streams), the same on every rank of
        a space group."""
        return self._step(state, points, mask, t, self.plan(env))

    # ---- per rank ------------------------------------------------------
    def _step(self, state, points, mask, t, plan: GridPlan):
        dev, dt = self.tracker.device, self.tracker.dtype
        # the vmap fleet sums the points in the compute dtype (JAX sharding.py:
        # 321); the kernel fleet (f32 only) quantizes f32 points
        pts = torch.as_tensor(points, device=dev).to(
            torch.float32 if self._use_kernel_fleet else dt)
        msk = torch.as_tensor(mask, device=dev) != 0
        t = torch.as_tensor(t, device=dev).to(dt)
        if self._use_kernel_fleet:
            p = self._kernel_perceive(pts, msk, t, plan)
        else:
            # XLA compiles the JAX fleet on several devices into another
            # program, whose f16 circumcenter spells cy apart (mesh_program)
            with mesh_program(self.mesh.size() > 1):
                p = self._vmap_perceive(pts, msk, t, plan)
        cfg, gains = self.tracker.config, self.tracker.gains_xy
        # every local stream's track step in one K4 launch (B banks x 1 frame)
        st, o = track_batch(state, p.dets[:, None], p.det_valid[:, None], p.t[:, None],
                            config=cfg, gains_xy=gains)
        return st, _frame_output(TrackOutputs(*(f[:, 0] for f in o)), p)

    def _kernel_perceive(self, pts, msk, t, plan) -> Perception:
        cfg = self.tracker.config
        leaf, leaf_z = cfg.voxel_leaf_size, cfg.leaf_z
        if cfg.voxel_quant == "fast" or _v3_leaf_ok(leaf, leaf_z):
            b, n = msk.shape
            pad = (-n) % PAD_TO
            if pad:
                pts = torch.cat([pts, pts.new_zeros((b, pad, 3))], dim=1)
                msk = torch.cat([msk, msk.new_zeros((b, pad))], dim=1)
            finalize = finalize_fast_stacked if cfg.voxel_quant == "fast" else finalize_exact_stacked
            raw, n_pts = digit_sums_stacked(pts.contiguous(), msk, cfg.scene, leaf, leaf_z,
                                            cfg.voxel_quant)
            dist.all_reduce(raw, group=self._space)
            dist.all_reduce(n_pts, group=self._space)
            accs = finalize(raw, cfg.scene, leaf, leaf_z)
        else:
            # exact mode past the two-digit leaf bound: bf16x3 sums (K6),
            # summed over the point shards in f32
            accs, n_pts = onehot_accumulate_stacked(pts, msk, cfg.scene, leaf, leaf_z, quant="exact")
            dist.all_reduce(accs, group=self._space)
            dist.all_reduce(n_pts, group=self._space)
        return _perceive_batch_from_dense_acc(accs, t, n_pts, plan, config=cfg)

    def _vmap_perceive(self, pts, msk, t, plan) -> Perception:
        cfg = self.tracker.config
        accs, n_pts = voxel_accumulate_stacked(pts, msk, cfg.scene, cfg.voxel_leaf_size, cfg.leaf_z)
        if accs.dtype in (torch.bfloat16, torch.float16):
            accs = half_psum(accs, self._space)
        else:
            dist.all_reduce(accs, group=self._space)
        dist.all_reduce(n_pts, group=self._space)
        return perceive_from_acc_stacked(accs, t, n_pts, plan, config=cfg)
