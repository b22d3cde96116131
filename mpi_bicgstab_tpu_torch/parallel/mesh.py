"""The process grid (counterpart of mpi_bicgstab_tpu/parallel/mesh.py).

The reference's process topology is MPI_COMM_WORLD, a flat rank list
(matrix.c:278-279); the JAX package's is a 1-D device mesh with one axis
`rows` (or a 2-D rows x sigma mesh for a sharded shift ladder). Here it
is the torch.distributed world that parallel/launch.py starts, one
process per device: make_row_mesh and make_grid_mesh return this rank's
view of it, with the process groups its collectives run over.

Ranks are laid out as the JAX mesh's reshape(n_rows, n_sigma) lays out
its devices: rank = row * n_sigma + sigma. The `rows` group of a rank
joins the ranks of its sigma index (the row partition), its `sigma`
group the ranks of its row index (the ladder's groups). Every rank
creates every group, in the same order, as torch.distributed requires;
ranks beyond the grid take part in that and in nothing else (`member`).

The backend follows the device: NCCL for CUDA tensors, gloo for the CPU,
as chosen when the world was started; a grid on a device its backend
does not serve raises. There is no silent switch between them.
"""
from __future__ import annotations

import dataclasses
import os

import torch

ROWS = "rows"
SIGMA = "sigma"
_BACKEND_DEVICE = {"nccl": "cuda", "gloo": "cpu"}
_GROUPS: dict = {}


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of an n_rows x n_sigma grid of ranks."""

    n_rows: int
    n_sigma: int
    rank: int                 # world rank
    device: torch.device
    rows: object = None       # process group along the rows axis
    sigma: object = None      # process group along the sigma axis

    @property
    def size(self) -> int:
        return self.n_rows * self.n_sigma

    @property
    def member(self) -> bool:
        return self.rank < self.size

    @property
    def row_index(self) -> int:
        return self.rank // self.n_sigma

    @property
    def sigma_index(self) -> int:
        return self.rank % self.n_sigma

    @property
    def shape(self) -> dict:
        return {ROWS: self.n_rows, SIGMA: self.n_sigma}


def _group(ranks: tuple):
    """The process group of `ranks` (the world's own group for all of
    them); created once per process, by every rank in the same order."""
    import torch.distributed as dist
    if ranks == tuple(range(dist.get_world_size())):
        return dist.group.WORLD
    if ranks not in _GROUPS:
        _GROUPS[ranks] = dist.new_group(list(ranks))
    return _GROUPS[ranks]


def _device(device, need: int) -> torch.device:
    """This rank's device: cuda:<local rank> on the card, the CPU when
    asked for; the world's backend must serve it."""
    import torch.distributed as dist
    backend = dist.get_backend()
    if device is None:
        if backend not in _BACKEND_DEVICE:
            raise ValueError(f"backend {backend!r}: pass device= "
                             f"('cuda' for nccl, 'cpu' for gloo)")
        device = _BACKEND_DEVICE[backend]
    dev = torch.device(device)
    if _BACKEND_DEVICE.get(backend) != dev.type:
        raise ValueError(f"a {dev.type} grid needs the "
                         f"{'nccl' if dev.type == 'cuda' else 'gloo'} "
                         f"backend, the world runs {backend!r}")
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        if need > count:
            raise ValueError(f"requested {need} devices, only {count} "
                             f"present")
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        dev = torch.device("cuda", local)
    return dev


def make_grid_mesh(n_rows: int, n_sigma: int, device=None) -> Mesh:
    """The 2-D (rows x sigma) grid for sigma-sharded shifted solves: the
    row partition of A and the vectors on one axis, the shift ladder's
    [S, n] slabs on the other (parallel/sigma.py). Uses the first
    n_rows * n_sigma ranks of the world; call it on every rank."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised: start "
                           "the ranks with parallel.launch")
    world = dist.get_world_size()
    need = n_rows * n_sigma
    if need > world:
        raise ValueError(f"requested {n_rows}x{n_sigma} mesh, only "
                         f"{world} devices present")
    dev = _device(device, need)
    rank = dist.get_rank()
    rows = [_group(tuple(r * n_sigma + s for r in range(n_rows)))
            for s in range(n_sigma)]
    sigma = [_group(tuple(r * n_sigma + s for s in range(n_sigma)))
             for r in range(n_rows)] if n_sigma > 1 else None
    if rank >= need:
        return Mesh(n_rows, n_sigma, rank, dev)
    return Mesh(n_rows, n_sigma, rank, dev, rows=rows[rank % n_sigma],
                sigma=sigma[rank // n_sigma] if sigma else None)


def make_row_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """The 1-D grid over the first n_devices (default: all) ranks."""
    import torch.distributed as dist
    if n_devices is None and dist.is_initialized():
        n_devices = dist.get_world_size()
    if n_devices is not None and dist.is_initialized() \
            and n_devices > dist.get_world_size():
        raise ValueError(f"requested {n_devices} devices, only "
                         f"{dist.get_world_size()} present")
    return make_grid_mesh(int(n_devices or 1), 1, device)
