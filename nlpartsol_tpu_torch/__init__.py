"""nlpartsol_tpu_torch — the PyTorch/CUDA port of the nlpartsol_tpu MPM framework.

A second package beside the JAX reference ``nlpartsol_tpu``: the same
directory layout and function names, plain functions on ``torch`` tensors,
frozen dataclasses for state, and hand-written CUDA kernels (``csrc/``) in
place of the reference's fused transfer kernels.  Ported so far: the 2D
explicit Newmark predictor-corrector step with LME shape functions on a
structured grid (``formulations/explicit.py``).

Entry points create their tensors on ``device="cuda"`` unless the caller
asks for another device; nothing falls back to the CPU on its own.
"""

# Importing config pins process-level numerics (solver dtype, full float32
# matmul precision with TF32 off; see config.py).
from . import config  # noqa: F401

__version__ = "0.1.0"
