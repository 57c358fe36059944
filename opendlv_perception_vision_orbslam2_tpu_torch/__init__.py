"""PyTorch/CUDA port of the ORB-SLAM2-class stereo engine (first slice).

The JAX package ``opendlv_perception_vision_orbslam2_tpu`` is the reference;
this package mirrors its layout and module names so each counterpart is easy
to find:

  ops/       geometry + image/feature ops (SE3, pyramid, FAST, ORB, Hamming,
             stereo, matching) and the two hand-written CUDA kernels'
             wrappers (``fast_kernel``, ``gather_kernel``)
  models/    frame containers, ORB extractor, stereo front end, VO tracker
  optim/     EPnP RANSAC and pose-only Gauss-Newton
  utils/     config (copied verbatim), numpy synthetic world, ATE,
             JAX<->torch state conversion
  csrc/      CUDA C++ sources, built with nvcc at first use into ``_build/``

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
