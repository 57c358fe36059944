"""PyTorch/CUDA port of the ORB-SLAM2-class SLAM engine (stereo, RGB-D, mono).

The JAX package ``opendlv_perception_vision_orbslam2_tpu`` is the reference;
this package mirrors its layout and module names so each counterpart is easy
to find:

  ops/       geometry + image/feature ops (SE3/Sim3, Horn, pyramid, FAST,
             ORB, Hamming, stereo, matching) and the two hand-written CUDA
             kernels' wrappers (``fast_kernel``, ``gather_kernel``)
  models/    frame containers, ORB extractor, stereo / RGB-D / mono front
             ends, VO tracker, map, mapping stage, place recognition,
             relocalization, loop closing, global BA, the two-view
             initializer, the SLAM drivers (stereo and RGB-D, monocular)
  optim/     EPnP RANSAC, pose-only Gauss-Newton, grid local BA, global BA,
             the essential-graph pose graph
  utils/     config, trajectory and wgs84 (copied verbatim), numpy
             synthetic world, host fetches, JAX<->torch state conversion
  io/        the OD4 wire format and session (copied verbatim), the KITTI
             runner, the map checkpoint, shared-memory camera ingest
  native/    ctypes loader of the repo's ``native/`` C++ host runtime (PNG
             decode, cluon shared memory, UDP), built at first use
  csrc/      CUDA C++ sources, built with nvcc at first use into ``_build/``
  __main__   the CLI: ``python -m opendlv_perception_vision_orbslam2_tpu_torch``
             with the reference microservice's flags (``Selflocalization``,
             in ``models/selflocalization.py``, is the service it runs)

Dispatch rule for every kernel wrapper: a CPU tensor takes the plain PyTorch
version, a CUDA tensor launches the CUDA kernel (or raises).  Nothing here
imports jax.
"""

import torch as _torch

# fp32 policy, stated once: the reference runs pose/BA algebra and the
# pyramid in full float32 (jax_default_matmul_precision="float32",
# Precision.HIGHEST in ops/image.py).  TF32 keeps ~10 mantissa bits, which
# would perturb the pyramid, the descriptor blur and the pose solves.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from .models.mono_slam import MonocularSlam  # noqa: E402
from .models.slam import StereoSlam  # noqa: E402
from .models.tracking import StereoVisualOdometry  # noqa: E402

__all__ = ["MonocularSlam", "StereoSlam", "StereoVisualOdometry"]
