"""Core state types: frozen dataclasses that hold tensors.

Counterpart of ``nlpartsol_tpu/types.py``.  The system has no learned
parameters, so there is no ``nn.Module``: :class:`Grid` and
:class:`Particles` are immutable records with ``.replace()`` and
``.to(device)``; steps are plain functions from records to records.
"""

from __future__ import annotations

import dataclasses
from functools import reduce
from typing import Optional

import torch

from . import config

Tensor = torch.Tensor


def _prod(xs):
    return reduce(lambda a, b: a * b, xs, 1)


class Record:
    """Mixin for frozen dataclasses whose fields may be tensors."""

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    def map_tensors(self, fn):
        """Apply ``fn`` to every tensor field (other fields pass through)."""
        return dataclasses.replace(
            self,
            **{
                f.name: fn(getattr(self, f.name))
                for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)
            },
        )

    def to(self, device):
        return self.map_tensors(lambda t: t.to(device))


@dataclasses.dataclass(frozen=True)
class Grid(Record):
    """Structured Cartesian background grid.

    Nodes sit at ``origin + i * h`` for multi-index ``i`` in ``dims`` (number
    of nodes per axis).  Flat node index is C-order (last axis fastest).
    """

    dims: tuple  # nodes per axis
    spacing: float  # h (uniform)
    origin: tuple
    # Per-node masks, flat (n_nodes,):
    active: Optional[Tensor] = None  # nodes allowed to carry dofs (None => all)
    # Dirichlet: per node, per dim: True where displacement is prescribed
    dirichlet_mask: Optional[Tensor] = None  # (n_nodes, d) bool or None
    dirichlet_value: Optional[Tensor] = None  # (n_nodes, d) prescribed increment
    # Node-plane validity range: planes with index outside
    # [valid_lo, valid_hi] are masked out of every shape-function window
    # (phantom padding of a local grid strip).  Plain ints: an int bounds
    # axis 0 only, a (d,) tuple bounds every axis.  None => all planes real.
    valid_lo: Optional[object] = None
    valid_hi: Optional[object] = None

    @property
    def dim(self) -> int:
        return len(self.dims)

    @property
    def n_nodes(self) -> int:
        return _prod(self.dims)

    def node_coords(self, device="cuda") -> Tensor:
        """(n_nodes, d) node positions (for I/O and debugging; the transfer
        paths compute positions from indices)."""
        axes = [
            torch.arange(n, dtype=config.dtype(), device=device) * self.spacing + o
            for n, o in zip(self.dims, self.origin)
        ]
        mesh = torch.meshgrid(*axes, indexing="ij")
        return torch.stack([m.reshape(-1) for m in mesh], dim=-1)

    def flat_index(self, multi: Tensor) -> Tensor:
        """C-order flat index from (..., d) integer multi-indices."""
        strides = []
        s = 1
        for n in reversed(self.dims):
            strides.append(s)
            s *= n
        strides = torch.tensor(
            list(reversed(strides)), dtype=multi.dtype, device=multi.device
        )
        return torch.sum(multi * strides, dim=-1)

    def cell_of(self, x: Tensor) -> Tensor:
        """Integer cell (lower-left node multi-index) containing position x.

        A true division by ``h``, never a product with ``1/h``: a particle
        on a cell face must land in the same cell as in every other place
        that bins it."""
        org = torch.tensor(self.origin, dtype=x.dtype, device=x.device)
        return torch.floor((x - org) / self.spacing).to(config.index_dtype())

    def valid_bounds(self):
        """Per-axis inclusive node-index bounds ``(lo, hi)`` as int tuples:
        in-grid ∧ valid_lo ≤ i ≤ valid_hi."""

        def norm(v, default):
            if v is None:
                return list(default)
            if isinstance(v, (tuple, list)):
                if len(v) == self.dim:
                    return [int(a) for a in v]
                (v,) = v
            return [int(v)] + list(default[1:])

        lo = norm(self.valid_lo, [0] * self.dim)
        hi = norm(self.valid_hi, [n - 1 for n in self.dims])
        lo = tuple(max(0, a) for a in lo)
        hi = tuple(min(n - 1, a) for n, a in zip(self.dims, hi))
        return lo, hi


@dataclasses.dataclass(frozen=True)
class Particles(Record):
    """SoA particle state.

    All arrays are statically sized to the particle capacity; ``active``
    masks padding.  Tensors are stored (Np, d, d); plane-strain zz channels
    are the ``*_zz`` scalars.  Every field of the reference is carried, so
    slot permutes and later slices need no relayout.
    """

    # Kinematics
    x: Tensor  # (Np, d) current position
    v: Tensor  # (Np, d) velocity
    a: Tensor  # (Np, d) acceleration
    dis: Tensor  # (Np, d) accumulated displacement
    # Mass / volume
    mass: Tensor  # (Np,)
    rho: Tensor  # (Np,) current density
    vol0: Tensor  # (Np,) reference volume
    # Deformation
    F: Tensor  # (Np, d, d) deformation gradient at t=n
    dFdt: Tensor  # (Np, d, d) rate of F at t=n
    J: Tensor  # (Np,) det F (x Fzz in plane strain; Fzz=1)
    # Constitutive state
    bemi: Tensor  # (Np, d, d) elastic left Cauchy-Green MINUS IDENTITY
    bemi_zz: Tensor  # (Np,) out-of-plane b_e − 1 (plane strain); zeros for 3D
    stress: Tensor  # (Np, d, d) Kirchhoff stress
    stress_zz: Tensor  # (Np,)
    eps: Tensor  # (Np,) equivalent plastic strain
    kappa: Tensor  # (Np,) hardening internal variable
    # Soil-water mixture state (u-pw formulation)
    pw: Tensor  # (Np,) Kirchhoff pore water pressure
    dpw_dt: Tensor  # (Np,) rate of pore water pressure
    pw0: Tensor  # (Np,) initial Cauchy pore pressure
    rho_s: Tensor  # (Np,) intrinsic solid density
    rho_f: Tensor  # (Np,) intrinsic fluid density
    phi_s: Tensor  # (Np,) solid volume fraction
    phi_f: Tensor  # (Np,) fluid volume fraction
    dJdt: Tensor  # (Np,) rate of the soil-skeleton jacobian
    back_stress: Tensor  # (Np, 3) principal back stress (kinematic hardening)
    W: Tensor  # (Np,) strain-energy density
    damage: Tensor  # (Np,) damage in [0, 1]
    strain_f: Tensor  # (Np,) eigensoftening failure strain
    # Bookkeeping
    pid: Tensor  # (Np,) int32 stable particle identity (survives slot permutes)
    mat_id: Tensor  # (Np,) int32 material index
    active: Tensor  # (Np,) bool — padding/erosion mask
    lme_lambda: Tensor  # (Np, d) LME Lagrange-multiplier warm start
    lme_beta: Tensor  # (Np, d, d) aLME anisotropic thermalisation tensor

    @property
    def count(self) -> int:
        return self.x.shape[0]

    @property
    def dim(self) -> int:
        return self.x.shape[1]


def make_particles(
    x,
    mass,
    vol0,
    mat_id=None,
    v=None,
    rho=None,
    active=None,
    device="cuda",
) -> Particles:
    """Construct an initialised particle set (F and b_e start as identity)."""
    dt = config.dtype()

    def arr(a, dtype=dt):
        return torch.as_tensor(a, dtype=dtype, device=device)

    x = arr(x)
    np_, d = x.shape

    def zeros(*trail, dtype=dt):
        return torch.zeros((np_,) + trail, dtype=dtype, device=device)

    mass = arr(mass)
    vol0 = arr(vol0)
    return Particles(
        x=x,
        v=zeros(d) if v is None else arr(v),
        a=zeros(d),
        dis=zeros(d),
        mass=mass,
        rho=(mass / vol0) if rho is None else arr(rho),
        vol0=vol0,
        F=torch.eye(d, dtype=dt, device=device).expand(np_, d, d).contiguous(),
        dFdt=zeros(d, d),
        J=torch.ones((np_,), dtype=dt, device=device),
        bemi=zeros(d, d),
        bemi_zz=zeros(),
        stress=zeros(d, d),
        stress_zz=zeros(),
        eps=zeros(),
        kappa=zeros(),
        pw=zeros(),
        dpw_dt=zeros(),
        pw0=zeros(),
        rho_s=zeros(),
        rho_f=zeros(),
        phi_s=zeros(),
        phi_f=zeros(),
        dJdt=zeros(),
        back_stress=zeros(3),
        W=zeros(),
        damage=zeros(),
        strain_f=zeros(),
        pid=torch.arange(np_, dtype=torch.int32, device=device),
        mat_id=zeros(dtype=torch.int32) if mat_id is None else arr(mat_id, torch.int32),
        active=(
            torch.ones((np_,), dtype=torch.bool, device=device)
            if active is None
            else arr(active, torch.bool)
        ),
        lme_lambda=zeros(d),
        lme_beta=zeros(d, d),
    )
