"""Multi-process (multi-GPU) training support.

Counterpart of `wildgaussians_tpu/parallel/multihost.py` on
torch.distributed:

  - every process calls `init_multihost()` once at start-up; it reads
    torchrun's environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK,
    LOCAL_RANK), as the JAX one reads JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES and JAX_PROCESS_ID, and joins NCCL on cuda:LOCAL_RANK
    (gloo with device="cpu"). A single process with no such environment is
    a no-op; where the environment names a group that cannot form, it
    raises;
  - training runs the same camera on every rank each step:
    `step_camera_id` derives the pick from the step counter alone;
  - `global_tile_mesh()` is the one-axis mesh over every rank, for
    `parallel.mesh.use_mesh`; `host_tile_rows` and `make_global_image` give
    a rank's band of an image's tile rows.

A run on N GPUs of one machine:
`torchrun --nproc-per-node N script.py`, where the script calls
`init_multihost()` and trains under `use_mesh(global_tile_mesh())`.
"""
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .mesh import TileMesh, make_tile_mesh

_device: Optional[torch.device] = None


def init_multihost(init_method: Optional[str] = None,
                   world_size: Optional[int] = None,
                   rank: Optional[int] = None,
                   local_rank: Optional[int] = None,
                   device: Optional[str] = None) -> bool:
    """Initialize torch.distributed for a multi-process run.

    Explicit arguments win; otherwise torchrun's environment is read
    (init_method "env://" from MASTER_ADDR / MASTER_PORT). The backend is
    NCCL on cuda:local_rank, or gloo on the CPU with device="cpu". Returns
    True when a group of more than one process is set up, False for the
    single-process no-op (no address and a world of at most 1; a world of 1
    named explicitly is set up and returns False). Safe to call twice."""
    global _device
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if world_size is None:
        world_size = int(env.get("WORLD_SIZE", "0") or 0)
    if init_method is None and "MASTER_ADDR" not in env and world_size <= 1:
        return False
    if rank is None:
        rank = int(env.get("RANK", "0"))
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", str(rank)))
    if world_size <= 0:
        raise RuntimeError("init_multihost: no world size (WORLD_SIZE or world_size=)")
    if device == "cpu":
        backend, _device = "gloo", torch.device("cpu")
    else:
        _device = torch.device("cuda", local_rank)
        torch.cuda.set_device(_device)
        backend = "nccl"
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return world_size > 1


def global_tile_mesh() -> TileMesh:
    """The one-axis mesh over every rank of the default group."""
    return make_tile_mesh(None, _device)


def step_camera_id(step: int, num_cameras: int, seed: int = 0) -> int:
    """Deterministic camera pick, the same on every rank: a per-epoch
    permutation without replacement from (seed, epoch), as the reference's
    shuffled stack."""
    epoch, pos = divmod(step, num_cameras)
    perm = np.random.default_rng((seed, epoch)).permutation(num_cameras)
    return int(perm[pos])


def host_tile_rows(height: int, tile_size: int = 16,
                   mesh: Optional[TileMesh] = None) -> tuple:
    """The [row0, row1) pixel-row band of the image this rank feeds: the
    ranks own contiguous bands of tile rows (grid_y divisible by D keeps
    them equal). One process without a group owns every row."""
    if mesh is not None:
        index, count = mesh.rank, mesh.size
    elif dist.is_initialized():
        index, count = dist.get_rank(), dist.get_world_size()
    else:
        index, count = 0, 1
    grid_y = (height + tile_size - 1) // tile_size
    rows_per = (grid_y + count - 1) // count
    r0 = min(index * rows_per, grid_y) * tile_size
    r1 = min((index + 1) * rows_per, grid_y) * tile_size
    return r0, min(r1, height)


def make_global_image(local_band: np.ndarray, height: int, width: int,
                      mesh: TileMesh) -> torch.Tensor:
    """This rank's band of an [height, width, 3] image (`host_tile_rows`)
    as a tensor on its device, checked against the band's shape."""
    r0, r1 = host_tile_rows(height, mesh=mesh)
    band = np.ascontiguousarray(local_band)
    if band.shape[:2] != (r1 - r0, width):
        raise ValueError(f"rank {mesh.rank} feeds rows [{r0}, {r1}) of width {width}, "
                         f"got a band of shape {band.shape}")
    return torch.as_tensor(band, device=mesh.device)
