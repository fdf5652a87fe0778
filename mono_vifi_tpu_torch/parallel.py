"""Multi-card training (counterpart of mono_vifi_tpu/parallel/__init__.py;
reference train.py:1178-1184 and :205-227).

The JAX package runs one SPMD program over a 1-D `data` mesh: the batch is
sharded, the parameters replicated, and XLA inserts the collectives. The
port trains the reference's way, one process per card in a
`torch.distributed` process group (NCCL on CUDA, gloo on the CPU):
  - each rank holds a full replica and takes `batch_size` samples a step
    (per-card batch, as the JAX package's per-device batch);
  - `models.common.BatchNorm2d` normalizes over the global batch (one
    all-reduce of per-channel sums forward, one backward);
  - the step averages the gradients and the logged metrics over the ranks
    (`all_reduce_mean_`, one flat buffer per dtype);
  - rank 0 writes logs and checkpoints and evaluates.

How the ranks start:
  distributed=True    one rank from the `torch.distributed` env rendezvous
                      (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
                      MASTER_PORT), as `torchrun` sets it
  num_devices N > 1   `spawn_local` starts N ranks on this host, one a card,
                      through a file rendezvous (0: every visible card)
  otherwise           no process group and no collective: the one-card path
"""

from __future__ import annotations

import os
import tempfile

import torch
import torch.distributed as dist


def active() -> bool:
    """Whether this process is a rank of a process group."""
    return dist.is_available() and dist.is_initialized()


def rank_and_world() -> tuple[int, int]:
    """(rank, world size) of the process group; (0, 1) without one."""
    if active():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_world_size(cfg) -> int:
    """Ranks that `num_devices` starts on this host: 0 means every visible
    card on CUDA and one process on any other device."""
    if torch.device(cfg.device).type != "cuda":
        return max(cfg.num_devices, 1)
    return cfg.num_devices or max(torch.cuda.device_count(), 1)


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _bind(device, local_rank: int) -> None:
    """Make this rank's card the current one: `cuda` binds to the local
    rank's card, `cuda:<i>` to card i."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank if dev.index is None else dev.index)


def init_distributed(cfg) -> tuple[int, int]:
    """-> (rank, world size). A process group that exists (made by
    `spawn_local` or by the caller) is used as it is. Otherwise
    `cfg.distributed` makes one from the env rendezvous
    (`config.check_port_options` has checked it is set), bound to the card
    of LOCAL_RANK, on NCCL (CUDA) or gloo (CPU); without it there is no
    group and the result is (0, 1). A world that is not the ranks
    `num_devices` asks for (without `distributed`) is refused: `launch`
    starts them."""
    if not active() and cfg.distributed:
        _bind(cfg.device, int(os.environ["LOCAL_RANK"]))
        dist.init_process_group(default_backend(cfg.device), init_method="env://")
    rank, world = rank_and_world()
    if not cfg.distributed and world != local_world_size(cfg):
        raise RuntimeError(
            f"num_devices={cfg.num_devices} asks for {local_world_size(cfg)} ranks, but this "
            f"process is one of {world}: start the ranks with `launch`")
    return rank, world


def _spawned_rank(local_rank: int, fn, world: int, init_file: str, device, backend, args):
    os.environ["LOCAL_RANK"] = str(local_rank)
    _bind(device, local_rank)
    dist.init_process_group(backend or default_backend(device),
                            init_method=f"file://{init_file}", rank=local_rank,
                            world_size=world)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def spawn_local(fn, world: int, *args, device="cuda", backend=None) -> None:
    """Run `fn(*args)` in `world` new processes on this host, rank i bound
    to card i of `device` (or to `device`'s own index), joined in one
    process group through a file rendezvous in a temporary directory.
    Returns when every rank has finished; raises if any failed. `fn` and
    `args` must pickle (a module-level function)."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(
            _spawned_rank, args=(fn, world, os.path.join(tmp, "rendezvous"), device, backend,
                                 args),
            nprocs=world, join=True, start_method="spawn")


def launch(fn, cfg) -> None:
    """Run `fn(cfg)` as the options ask: one rank from the env rendezvous
    (`distributed`), `local_world_size(cfg)` spawned ranks, or this process
    alone."""
    if cfg.distributed:
        init_distributed(cfg)
        try:
            fn(cfg)
        finally:
            dist.destroy_process_group()
    elif local_world_size(cfg) > 1:
        spawn_local(fn, local_world_size(cfg), cfg, device=cfg.device)
    else:
        fn(cfg)


def _flat_groups(tensors):
    groups: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return groups.values()


def _unflatten_(flat, tensors) -> None:
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def all_reduce_mean_(tensors) -> None:
    """Average each tensor over the ranks, in place: one all-reduce of one
    flat buffer per dtype."""
    world = dist.get_world_size()
    for group in _flat_groups(tensors):
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        flat /= world
        _unflatten_(flat, group)


def broadcast_module_(module: torch.nn.Module, src: int = 0) -> None:
    """Copy rank `src`'s parameters and buffers to every rank (the JAX
    package's `replicate`): one broadcast of one flat buffer per dtype."""
    tensors = list({id(t): t for t in [*module.parameters(), *module.buffers()]}.values())
    with torch.no_grad():
        for group in _flat_groups(tensors):
            flat = torch.cat([t.reshape(-1) for t in group])
            dist.broadcast(flat, src)
            _unflatten_(flat, group)


def barrier() -> None:
    """Wait for every rank (nothing without a process group)."""
    if not active():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()
