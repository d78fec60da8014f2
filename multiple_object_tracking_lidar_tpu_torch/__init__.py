"""PyTorch/CUDA port of multiple_object_tracking_lidar_tpu (the JAX package).

The JAX package is the reference; this package mirrors its layout so a
module's counterpart sits under the same path.  Each Pallas kernel on the
ported path is a CUDA kernel written by hand for Hopper (``csrc/*.cu``),
wrapped in an ``ops/*_cuda.py`` module beside its plain PyTorch version:
a CUDA tensor launches the kernel, a CPU tensor runs the plain version.

Host modules that need only numpy (``config``, ``utils/*``, ``io/*``,
``models/matern32``, ``outputs/messages``, ``outputs/svg``, the stage
timers of ``runtime/profiler`` and the f64 gain builders in
``models/ihgp``) are copies: the JAX package's ``__init__`` imports JAX, so
none of its modules can be imported where JAX is absent.  The tests pin
each copy against its original.

This package never imports JAX.
"""

import torch

from multiple_object_tracking_lidar_tpu_torch.config import (
    Capacities,
    SceneBounds,
    TrackerConfig,
    load_config,
)
from multiple_object_tracking_lidar_tpu_torch.tracker.state import TrackerState, Frame
from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker

# Any f32 matmul left in the port must run in full f32 (the JAX package pins
# Precision.HIGHEST where it matters); TF32 keeps ~3 decimal digits.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

__all__ = [
    "TrackerConfig",
    "Capacities",
    "SceneBounds",
    "load_config",
    "TrackerState",
    "Frame",
    "Tracker",
    "__version__",
]
