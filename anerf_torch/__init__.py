"""anerf_torch: the PyTorch/CUDA port of anerf_tpu for NVIDIA Hopper.

Plain tensor code is PyTorch; each Pallas kernel of ``anerf_tpu`` is a
CUDA C++ kernel under ``csrc/`` with a plain-PyTorch twin beside its
wrapper.  Nothing here imports JAX or ``anerf_tpu``:
the numpy modules the port needs are kept as copies.
"""

__version__ = '0.1.0'

from . import skeleton  # noqa: F401
from .skeleton import Skeleton, SMPLSkeleton, SMPL_REST_POSE  # noqa: F401
