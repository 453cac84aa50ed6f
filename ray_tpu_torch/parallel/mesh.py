"""Device mesh: the counterpart of ``ray_tpu/parallel/mesh.py``.

A mesh names the six parallelism axes, in the JAX package's canonical
order, and lays the job's devices out over them: one device for each
process of the ``torch.distributed`` world, in rank order. Where the world
has more than one process, the mesh holds a
``torch.distributed.DeviceMesh`` with ``mesh_dim_names=AXIS_ORDER``, built
on the default process group that the caller initialised (give
``init_process_group`` its address, world size and rank). A world of one
process needs no process group: every reduction over an axis is then the
identity.

``Mesh.group(axes)`` is the process group of this rank's line along one
axis or several taken together (the batch group of ``fsdp`` is
``("data", "fsdp")``), and ``Mesh.axis(axes)`` this rank's place on it.

The mesh also carries the context of a running step (``data_parallel``):
the mesh and the axes of its batch group. A loss that needs a mean over
the whole batch (``models.gpt.gpt_loss``) sums its counts over the batch
group there (``all_sum``), as GSPMD makes the JAX loss global, and the
model reads the tensor, expert and sequence axes it is split over
(``step_axis``).

The slice-topology helpers of the JAX module (``SliceInfo``,
``detect_slice_id``, ``detect_zone``, ``slice_bundles``) read TPU metadata
and stay on the TPU side.
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
import math
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch import resolve_device

AXIS_ORDER = ("data", "fsdp", "expert", "pipeline", "sequence", "tensor")

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class MeshConfig:
    """Sizes for each parallelism axis; -1 on `data` means "the rest"."""

    data: int = -1
    fsdp: int = 1
    expert: int = 1
    pipeline: int = 1
    sequence: int = 1
    tensor: int = 1

    def axis_sizes(self, n_devices: int) -> Dict[str, int]:
        sizes = {"data": self.data, "fsdp": self.fsdp, "expert": self.expert,
                 "pipeline": self.pipeline, "sequence": self.sequence,
                 "tensor": self.tensor}
        fixed = math.prod(v for v in sizes.values() if v > 0)
        n_auto = sum(1 for v in sizes.values() if v <= 0)
        if n_auto > 1:
            raise ValueError("at most one axis may be -1")
        if n_auto == 1:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {fixed}")
            auto = n_devices // fixed
            sizes = {k: (auto if v <= 0 else v) for k, v in sizes.items()}
        total = math.prod(sizes.values())
        if total > n_devices:
            raise ValueError(
                f"mesh axes {sizes} need {total} devices, have {n_devices}")
        return sizes

    @classmethod
    def from_dict(cls, d: Dict[str, int]) -> "MeshConfig":
        unknown = set(d) - set(AXIS_ORDER)
        if unknown:
            raise ValueError(f"unknown mesh axes {sorted(unknown)}")
        return cls(**{k: d[k] for k in AXIS_ORDER if k in d})


class Mesh:
    """Devices laid out over ``AXIS_ORDER``.

    ``devices`` is a numpy object array of ``torch.device`` shaped by the
    axis sizes (as ``jax.sharding.Mesh.devices``), holding rank r's device
    at flat index r. ``rank`` is this process's rank in the world and
    ``device_mesh`` the ``DeviceMesh`` over the same ranks (None in a world
    of one process, and in a ``fake_mesh``)."""

    axis_names = AXIS_ORDER

    def __init__(self, devices: np.ndarray, rank: int = 0,
                 device_mesh=None):
        self.devices = devices
        self.rank = rank
        self.device_mesh = device_mesh
        self._groups: Dict[Tuple[str, ...], Any] = {}

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(AXIS_ORDER, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def _check_rank(self) -> None:
        if self.rank >= self.size:
            raise ValueError(f"rank {self.rank} is outside the mesh of "
                             f"{self.size} devices")

    @property
    def device(self) -> torch.device:
        """This process's device."""
        self._check_rank()
        return self.devices.flat[self.rank]

    def coordinate(self) -> Dict[str, int]:
        """This process's index along each axis."""
        self._check_rank()
        return dict(zip(AXIS_ORDER, (int(i) for i in np.unravel_index(
            self.rank, self.devices.shape))))

    def _axes(self, axes: Union[str, Sequence[str]]) -> Tuple[str, ...]:
        """``axes`` in the canonical order, those of size 1 left out."""
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = set(names) - set(AXIS_ORDER)
        if unknown:
            raise ValueError(f"unknown mesh axes {sorted(unknown)}")
        return tuple(a for a in AXIS_ORDER if a in names and self.shape[a] > 1)

    def group(self, axes: Union[str, Sequence[str]]):
        """The process group of this rank's line along ``axes`` (one axis
        name, or several taken together): the ranks whose coordinates
        differ from this rank's in those axes only. None where they have
        size 1 together (the reduction over them is the identity).

        Every rank of the world must ask for a group of several axes at the
        same point of the program: its first request creates the groups of
        every line (``torch.distributed.new_subgroups_by_enumeration``)."""
        names = self._axes(axes)
        if not names:
            return None
        if self.device_mesh is None:
            raise ValueError(
                f"axes {names} have size "
                f"{math.prod(self.shape[a] for a in names)} but the mesh has "
                "no process group (a fake_mesh, or a world of one process)")
        if len(names) == 1:
            return self.device_mesh.get_group(names[0])
        if names not in self._groups:
            dims = [AXIS_ORDER.index(a) for a in names]
            rest = [i for i in range(len(AXIS_ORDER)) if i not in dims]
            ranks = np.arange(self.size).reshape(self.devices.shape)
            lines = ranks.transpose(rest + dims).reshape(
                -1, math.prod(self.shape[a] for a in names))
            self._groups[names], _ = dist.new_subgroups_by_enumeration(
                lines.tolist())
        return self._groups[names]

    def axis(self, axes: Union[str, Sequence[str]]) -> "Axis":
        """This rank's place on ``axes`` taken together: their combined
        size, this rank's index (row-major over the axes in the canonical
        order, as a JAX spec entry ("data", "fsdp") counts) and the group."""
        names = self._axes(axes)
        if not names:
            return Axis()
        coord = self.coordinate()
        index = 0
        for a in names:
            index = index * self.shape[a] + coord[a]
        return Axis(math.prod(self.shape[a] for a in names), index,
                    self.group(names))


def _world() -> tuple:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _default_devices(world: int) -> list:
    """The card for each rank: cuda:<rank mod the host's card count>;
    raises without CUDA (ask for the CPU with ``devices``)."""
    resolve_device(None)
    return [torch.device("cuda", r % torch.cuda.device_count())
            for r in range(world)]


def _grid(config, devices, axis_sizes) -> np.ndarray:
    """The devices as an object array shaped by the axis sizes."""
    n = len(devices)
    if axis_sizes is None:
        config = config or MeshConfig()
        axis_sizes = config.axis_sizes(n)
    shape = tuple(axis_sizes[a] for a in AXIS_ORDER)
    # A config whose axis product is smaller than the device count uses the
    # first prod(shape) devices. Warn: silent under-subscription would hide
    # a throughput loss from a mis-sized axis.
    used = math.prod(shape)
    if used < n:
        logger.warning("mesh axes %s use %d of %d devices; the rest are idle",
                       dict(axis_sizes), used, n)
    grid = np.empty(used, dtype=object)
    grid[:] = [torch.device(d) for d in devices[:used]]
    return grid.reshape(shape)


def build_mesh(config: Optional[MeshConfig] = None,
               devices: Optional[Sequence[Union[str, torch.device]]] = None,
               axis_sizes: Optional[Dict[str, int]] = None) -> Mesh:
    """Build a Mesh with the canonical axis order.

    ``devices``: one per rank of the world, in rank order (default: the
    card on every rank; ``["cpu"] * world`` runs on the CPU). Axes of size
    1 are kept, so one strategy's specs work on any mesh shape."""
    world, rank = _world()
    if devices is None:
        devices = _default_devices(world)
    grid = _grid(config, list(devices), axis_sizes)
    device_mesh = None
    if world > 1:
        if len(devices) != world:
            raise ValueError(f"{len(devices)} devices for a world of {world} "
                             "processes: give one device per rank")
        from torch.distributed.device_mesh import DeviceMesh
        if grid.flat[0].type == "cuda" and rank < grid.size:
            # NCCL works on the current device: each rank on its own card.
            torch.cuda.set_device(grid.flat[rank])
        device_mesh = DeviceMesh(grid.flat[0].type,
                                 torch.arange(grid.size).reshape(grid.shape),
                                 mesh_dim_names=AXIS_ORDER)
    return Mesh(grid, rank, device_mesh)


def fake_mesh(n_devices: int = 8, **axis_sizes) -> Mesh:
    """A mesh of ``n_devices`` CPU devices in this one process, with no
    process group: the layout that sharding rules are computed on in tests
    (the counterpart of the JAX package's virtual-device CPU mesh). No
    step runs on it."""
    cfg = MeshConfig(**axis_sizes) if axis_sizes else None
    return Mesh(_grid(cfg, ["cpu"] * n_devices, None))


@dataclass(frozen=True)
class Axis:
    """One rank's place on a mesh axis, or on several taken together: their
    size, this rank's index, and the process group (None for a size of 1)."""

    size: int = 1
    index: int = 0
    group: Any = None


# ---------------------------------------------------------------------------
# The context of a running step
# ---------------------------------------------------------------------------

_STEP: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_torch_step", default=(None, ()))


@contextlib.contextmanager
def data_parallel(mesh: Optional[Mesh],
                  batch_axes: Sequence[str] = ("data",)) -> Iterator[None]:
    """Run the body as this rank's part of a step on ``mesh`` (None: one
    device), whose batch group is ``batch_axes`` taken together: the axes
    that split the batch's rows, and "sequence", which splits its tokens.
    ``all_sum`` sums over that group; ``step_axis`` reads the mesh."""
    token = _STEP.set((mesh, tuple(batch_axes)))
    try:
        yield
    finally:
        _STEP.reset(token)


def step_axis(axes: Union[str, Sequence[str]]) -> Axis:
    """This rank's place on ``axes`` in the running step; size 1 outside a
    step or without a mesh."""
    mesh, _ = _STEP.get()
    return Axis() if mesh is None else mesh.axis(axes)


def current_step() -> tuple:
    """(mesh, batch axes) of the running step: ``data_parallel(*it)``
    enters it again, where a thread does not inherit it (the CUDA autograd
    engine runs the backward, and a checkpoint's recompute, on its own)."""
    return _STEP.get()


def step_mesh() -> Optional[Mesh]:
    """The mesh of the running step (None outside a step, or without a
    mesh)."""
    return _STEP.get()[0]


def all_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the batch group of the running step; ``t`` itself
    outside one. No gradient flows through the sum: it is for the counts
    that make a mean global (tokens, expert choices)."""
    mesh, batch_axes = _STEP.get()
    group = None if mesh is None else mesh.group(batch_axes)
    if group is None:
        return t
    out = t.detach().clone()
    dist.all_reduce(out, group=group)
    return out
