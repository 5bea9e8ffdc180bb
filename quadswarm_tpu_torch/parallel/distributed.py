"""Process-group initialization and the data mesh of a job.

Port of quadswarm_tpu/parallel/distributed.py.  The JAX package runs one
process per host and a device mesh inside it; the port runs one process per
card, PyTorch's idiom: a world of D ranks (started by `torchrun`, or by the
JAX package's launch variables) trains one job, each rank on its own card
with its own share of the env batch (`parallel/mesh.py`).

    torchrun --nproc_per_node=<cards> -m quadswarm_tpu_torch.training.train \\
        --multi_host=True <train.sh's flags>

The backend follows from the layout, never from a failure:
- NCCL when every rank of a host has a card of its own;
- gloo on the CPU;
- gloo when ranks share a card (NCCL refuses two ranks on one device).  Gloo
  reduces and broadcasts CUDA tensors in place, so every tensor stays on
  the card; point-to-point transfers stage through host buffers
  (`mesh.send` / `mesh.recv`).
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from quadswarm_tpu_torch.parallel.mesh import DataMesh, make_mesh


def _env_int(name: str, default: int | None = None) -> int | None:
    value = os.environ.get(name)
    return default if value in (None, "") else int(value)


def choose_backend(device_type: str, ranks_on_host: int,
                   cards: int) -> tuple[str, str]:
    """(backend, reason) for a world whose ranks run on `device_type`, with
    `ranks_on_host` ranks on this host and `cards` cards in it."""
    if device_type != "cuda":
        return "gloo", "ranks on the CPU"
    if ranks_on_host > cards:
        return "gloo", (f"{ranks_on_host} ranks share {cards} card(s), which "
                        "NCCL refuses")
    return "nccl", "one card a rank"


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     init_method: str | None = None,
                     device: str = "cuda") -> None:
    """Join the job's process group, from the arguments or from the launch
    variables: torchrun's `MASTER_ADDR`, `MASTER_PORT`, `RANK`,
    `WORLD_SIZE` and `LOCAL_RANK`, or the JAX package's
    `JAX_COORDINATOR_ADDRESS` (host:port), `JAX_NUM_PROCESSES` and
    `JAX_PROCESS_ID`.  `init_method` (for example `file://<path>`) takes
    the place of an address.  Without any of them the process trains alone
    (a world of one, no group).  A no-op when the group exists.

    On CUDA each rank makes card `LOCAL_RANK % device_count` its current
    device before the group exists (`LOCAL_RANK` defaults to the rank;
    `LOCAL_WORLD_SIZE` gives the ranks of this host, all of them by
    default).  Call it before anything touches the card."""
    if dist.is_initialized():
        return
    address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if address or init_method:
        world = (num_processes if num_processes is not None
                 else _env_int("JAX_NUM_PROCESSES", 1))
        rank = (process_id if process_id is not None
                else _env_int("JAX_PROCESS_ID", 0))
        if not init_method:
            init_method = f"tcp://{address}"
    elif "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ:
        world = (num_processes if num_processes is not None
                 else _env_int("WORLD_SIZE"))
        rank = process_id if process_id is not None else _env_int("RANK", 0)
        init_method = "env://"
    else:
        return
    local_rank = _env_int("LOCAL_RANK", rank)
    ranks_on_host = _env_int("LOCAL_WORLD_SIZE", world)
    device_type = torch.device(device).type
    cards = torch.cuda.device_count() if device_type == "cuda" else 0
    if device_type == "cuda":
        if cards == 0:
            raise RuntimeError("no CUDA device is available; pass "
                               "--device=cpu for a world on the CPU")
        torch.cuda.set_device(local_rank % cards)
    backend, reason = choose_backend(device_type, ranks_on_host, cards)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    where = (f"cuda:{torch.cuda.current_device()}" if device_type == "cuda"
             else "cpu")
    print(f"torch.distributed: rank {rank}/{world} on {where}, backend "
          f"{backend} ({reason})", flush=True)


def global_data_mesh(device: str = "cuda") -> DataMesh:
    """The 1-D data mesh over every rank of the job (a world of one
    without a process group)."""
    return make_mesh(device=device)


def local_batch_size(global_batch: int) -> int:
    """This rank's share of a global env batch."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    assert global_batch % world == 0, (global_batch, world)
    return global_batch // world
