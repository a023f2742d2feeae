"""The ``(data, model)`` mesh on ``torch.distributed`` (the port's copy of
:mod:`gvl_tpu.parallel.mesh`).

Axis convention, as in the JAX package:

- ``data``  — batch dimension (data parallel; gradients sum here)
- ``model`` — weight dimension (tensor parallel; activations are reduced
  and gathered here)

JAX's mesh is single-controller: one process sees every device and GSPMD
inserts the collectives.  Here one process runs per rank and every rank
runs the same program in lockstep, with the collectives written out
(:mod:`gvl_tpu_torch.parallel.collectives`).  Rank ``r`` of a ``d x m``
mesh sits at ``(r // m, r % m)``: the ranks of a row form its ``model``
group (one data replica), those of a column its ``data`` group.

The backend and each rank's device are chosen once, by the layout, when the
world starts (:func:`init_distributed`): NCCL when every rank on the host
has a card of its own, gloo when ranks share a card or run on the CPU.  A
rank's device is ``cuda:{LOCAL_RANK % device_count}`` unless the caller asks
for the CPU; without a card a CUDA rank raises.  Nothing falls back on a
caught error.
"""

from __future__ import annotations

import datetime
import logging
import math
import os
from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.distributed as dist

from gvl_tpu_torch import resolve_device

logger = logging.getLogger(__name__)

DATA_AXIS = "data"
MODEL_AXIS = "model"

# set once per process by init_distributed: the layout's backend and device
_LAYOUT: dict = {}


def local_device_count() -> int:
    """Ranks of the world (1 without one): the port's devices are ranks."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _fit_axes(requested_data: int, requested_model: int, n: int) -> tuple[int, int]:
    """Shrink a requested (data, model) shape onto ``n`` devices.

    Preference order: keep the model axis as close to the request as
    possible (TP needs contiguous fast links), then grow data with the
    remainder.  Both axes always divide ``n`` exactly.
    """
    model = math.gcd(requested_model, n)
    # prefer the largest divisor of n that is <= requested_model
    for cand in range(min(requested_model, n), 0, -1):
        if n % cand == 0:
            model = cand
            break
    data = n // model
    if (data, model) != (requested_data, requested_model):
        logger.info(
            "mesh request (%d, %d) fitted to (%d, %d) over %d device(s)",
            requested_data, requested_model, data, model, n,
        )
    return data, model


def layout_backend(device: torch.device, local_world_size: int) -> str:
    """The backend the layout asks for: NCCL when each of the host's
    ``local_world_size`` ranks has a card of its own, gloo when ranks share
    a card or run on the CPU."""
    if device.type != "cuda":
        return "gloo"
    return "nccl" if local_world_size <= torch.cuda.device_count() else "gloo"


def init_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    local_rank: Optional[int] = None,
    local_world_size: Optional[int] = None,
    device: str | torch.device = "cuda",
    timeout: Optional[datetime.timedelta] = None,
) -> bool:
    """Join the world of ranks (torchrun's ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE`` and ``MASTER_ADDR``, or explicit
    arguments: ``init_method`` such as ``file:///tmp/store`` or
    ``tcp://localhost:29500``).

    Safe to call unconditionally: a single process (no ``init_method`` and
    no ``MASTER_ADDR``) is a no-op returning False, as in JAX.  The backend
    and this rank's device follow the layout (:func:`layout_backend`); both
    are read back by :func:`build_mesh` and named by
    :meth:`MeshManager.describe`.  ``device="cpu"`` puts every rank on the
    CPU (gloo)."""
    if dist.is_initialized():
        return True
    env = os.environ
    if init_method is None and "MASTER_ADDR" not in env:
        logger.debug("single-process run; torch.distributed not initialized")
        return False
    world_size = world_size if world_size is not None else int(env.get("WORLD_SIZE", 1))
    rank = rank if rank is not None else int(env.get("RANK", 0))
    local_rank = local_rank if local_rank is not None else int(env.get("LOCAL_RANK", rank))
    local_world_size = (local_world_size if local_world_size is not None
                        else int(env.get("LOCAL_WORLD_SIZE", world_size)))
    dev = torch.device(device)
    if dev.type == "cuda":
        resolve_device(dev)          # raises without a card
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    backend = layout_backend(dev, local_world_size)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kwargs = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank, **kwargs)
    _LAYOUT.update(device=dev, backend=backend)
    logger.info("torch.distributed initialized: rank %d/%d, %s on %s",
                rank, world_size, backend, dev)
    return True


def shutdown_distributed() -> None:
    """Leave the world (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _LAYOUT.clear()


@dataclass
class Mesh:
    """This rank's view of a ``(data, model)`` mesh: its coordinates, its
    two groups (None without a world) and the ranks in each."""

    shape: dict
    rank: int
    device: torch.device
    backend: Optional[str] = None
    data_group: object = None
    model_group: object = None
    data_ranks: list = field(default_factory=list)
    model_ranks: list = field(default_factory=list)

    @property
    def coords(self) -> tuple[int, int]:
        m = self.shape[MODEL_AXIS]
        return self.rank // m, self.rank % m

    @property
    def data_index(self) -> int:
        return self.coords[0]

    @property
    def model_index(self) -> int:
        return self.coords[1]


def build_mesh(
    data: int = 1,
    model: int = 1,
    strict: bool = False,
    device: Optional[str | torch.device] = None,
) -> Mesh:
    """Build a 2-D ``(data, model)`` mesh over the world's ranks (one rank
    without a world).

    Args:
        data / model: requested axis sizes.
        strict: if True, fail rather than shrink when the request does not
            match the number of ranks.
        device: this rank's device; default the one the layout chose in
            :func:`init_distributed` (``"cuda"`` without a world).

    Every rank must call this in the same order: it makes the groups of
    every row and column (``torch.distributed.new_group`` is collective).
    """
    n = local_device_count()
    if strict:
        if data * model != n:
            raise ValueError(
                f"mesh {data}x{model} needs {data * model} devices, have {n}"
            )
        d, m = data, model
    else:
        d, m = _fit_axes(data, model, n)
    if device is None:
        device = _LAYOUT.get("device", "cuda")
    dev = resolve_device(device)
    if not dist.is_initialized():
        return Mesh({DATA_AXIS: d, MODEL_AXIS: m}, 0, dev, None, None, None, [0], [0])
    rank = dist.get_rank()
    mesh = Mesh({DATA_AXIS: d, MODEL_AXIS: m}, rank, dev, dist.get_backend())
    for row in range(d):
        ranks = list(range(row * m, (row + 1) * m))
        group = dist.new_group(ranks)
        if rank in ranks:
            mesh.model_group, mesh.model_ranks = group, ranks
    for col in range(m):
        ranks = list(range(col, n, m))
        group = dist.new_group(ranks)
        if rank in ranks:
            mesh.data_group, mesh.data_ranks = group, ranks
    return mesh


def as_mesh(mesh) -> Optional[Mesh]:
    """A :class:`Mesh` from a mesh or a :class:`MeshManager` (None stays)."""
    return mesh.mesh if isinstance(mesh, MeshManager) else mesh


class MeshManager:
    """Owns the process's mesh: its sizes, this rank's place and groups.

    >>> init_distributed()                      # under torchrun
    >>> mm = MeshManager.from_preset(load_preset("full"))
    >>> engine = ContinuousBatchingEngine(cfg, state, mesh=mm)
    """

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    @classmethod
    def from_preset(cls, config, device=None) -> "MeshManager":
        mc = config.mesh
        return cls(build_mesh(mc.data_axis, mc.model_axis, device=device))

    @classmethod
    def single_device(cls, device=None) -> "MeshManager":
        """A 1 x 1 mesh of this process alone (no groups)."""
        dev = resolve_device(device if device is not None else _LAYOUT.get("device", "cuda"))
        return cls(Mesh({DATA_AXIS: 1, MODEL_AXIS: 1}, 0, dev, None, None, None, [0], [0]))

    @property
    def data_size(self) -> int:
        return self.mesh.shape[DATA_AXIS]

    @property
    def model_size(self) -> int:
        return self.mesh.shape[MODEL_AXIS]

    @property
    def num_devices(self) -> int:
        return self.data_size * self.model_size

    @property
    def rank(self) -> int:
        return self.mesh.rank

    @property
    def coords(self) -> tuple[int, int]:
        return self.mesh.coords

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    @property
    def backend(self) -> Optional[str]:
        return self.mesh.backend

    @property
    def data_group(self):
        return self.mesh.data_group

    @property
    def model_group(self):
        return self.mesh.model_group

    def pad_batch(self, n: int) -> int:
        """Round a batch size up so it divides evenly over the data axis."""
        d = self.data_size
        return ((n + d - 1) // d) * d

    def describe(self) -> str:
        backend = self.backend or "no world"
        return (
            f"Mesh({self.data_size}x{self.model_size} = {self.num_devices} "
            f"{self.device.type} device(s); {backend}; rank {self.rank} at "
            f"{self.coords} on {self.device})"
        )
