"""nlpartsol_tpu_torch — the PyTorch/CUDA port of the nlpartsol_tpu MPM framework.

A second package beside the JAX reference ``nlpartsol_tpu``: the same
directory layout and function names, plain functions on ``torch`` tensors,
frozen dataclasses for state, and hand-written CUDA kernels (``csrc/``) in
place of the reference's fused transfer kernels.

Entry points for a user: ``cli.py`` (``nl-partsol-torch --FORMULATION-U -f
sim.nlp``, or ``python -m nlpartsol_tpu_torch.cli``), and in Python
``io.builder.build_simulation`` (a ``.nlp`` deck with its GiD meshes) then
``driver.run_simulation`` (the time loop with VTK/CSV outputs and
checkpoints).  The paths they reach, in 2D and 3D on structured grids with
LME or FEM shape functions: the explicit NPC-FS step
(``formulations/explicit.py``), Forward-Euler and Generalized-α
(``integrators.py``), implicit Newmark-β and quasi-static
(``implicit.py``), the soil-water mixture explicit and implicit
(``upw.py``), mixed u-p (``up.py``) and Discrete Energy-Momentum
(``dem.py``), with every constitutive model of the reference on every
step; and the halo-sharded grid across ranks of a ``torch.distributed``
group (``parallel/``: 1-D and 2-D strips, seam migration, distributed
Newton-Krylov).  What the JAX package has and the port leaves out raises
``NotImplementedError`` naming ROADMAP.md's do-not-port list.

Entry points create their tensors on ``device="cuda"`` unless the caller
asks for another device; nothing falls back to the CPU on its own.
"""

# Importing config pins process-level numerics (solver dtype, full float32
# matmul precision with TF32 off; see config.py).
from . import config  # noqa: F401

__version__ = "0.1.0"
