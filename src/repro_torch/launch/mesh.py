"""Mesh construction: the production meshes, the host mesh, and ranks that share one card.

Torch twin of ``repro.launch.mesh``, on ``torch.distributed``'s
``DeviceMesh``.  Functions only: importing this module touches no process
group and no device.

* ``make_production_mesh(multi_pod)``: ``(data 16, model 16)`` or ``(pod 2,
  data 16, model 16)`` over the process group in place, whose world must be
  256 or 512 ranks.  The dry-run's is the fake one (``init_fake_world``):
  one process stands for rank 0 of the world, every collective returns at
  once, and nothing is allocated for the other ranks.
* ``make_host_mesh(device)``: the trivial 1 x 1 mesh on the local card (a
  one-rank process group is started if none is).
* ``run_ranks(fn, world, ...)``: ``world`` processes, each a rank of a gloo
  process group over ``tcp://localhost``, all on the same device (NCCL
  refuses two ranks on one card; gloo moves the bytes through the host).
"""

from __future__ import annotations

import os
import pickle
import socket
import traceback
from typing import Any, Callable, List, Sequence, Tuple

import torch
import torch.distributed as dist

POD_SHAPE = (16, 16)
POD_AXES = ("data", "model")
MULTI_POD_SHAPE = (2, 16, 16)
MULTI_POD_AXES = ("pod", "data", "model")


def device_mesh(device_type: str, shape: Sequence[int], names: Sequence[str]):
    """A DeviceMesh of ``shape`` over ranks 0..prod(shape)-1 of the process group in place."""
    from torch.distributed.device_mesh import DeviceMesh

    ranks = torch.arange(int(torch.tensor(shape).prod())).view(*shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cpu"):
    """16 x 16 = 256 ranks per pod; 2 pods = 512 ranks multi-pod."""
    shape, names = (MULTI_POD_SHAPE, MULTI_POD_AXES) if multi_pod else (POD_SHAPE, POD_AXES)
    return device_mesh(device_type, shape, names)


def make_host_mesh(device: torch.device | str = "cuda"):
    """Trivial 1 x 1 ``("data", "model")`` mesh on the local device."""
    device = torch.device(device)
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    return device_mesh(device.type, (1, 1), POD_AXES)


def init_fake_world(world: int) -> None:
    """Stand in for rank 0 of ``world`` ranks with torch's fake process-group backend."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, port, device, args, queue) -> None:
    try:
        # the ranks share the host's cores: each its own share of the intra-op threads
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(torch.device(device).index or 0)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=world)
        try:
            # pickled here: torch's queue would share tensors through file descriptors that
            # close with this process
            queue.put((rank, True, pickle.dumps(fn(rank, world, *args))))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises
        queue.put((rank, False, traceback.format_exc()))


def run_ranks(
    fn: Callable[..., Any],
    world: int,
    args: Tuple = (),
    *,
    device: torch.device | str = "cuda",
    timeout: float = 600.0,
) -> List[Any]:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes, all on ``device``.

    Each process joins a gloo process group of ``world`` ranks before it
    calls ``fn`` and leaves it after, with ``cpu_count // world`` intra-op
    threads.  Returns the ranks' results in rank
    order; raises with the first failing rank's traceback.  ``fn`` and
    ``args`` must pickle (``fn`` a module-level function).  Every process
    is ended before this returns.
    """
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, port, str(device), args, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    results: dict = {}
    try:
        for _ in range(world):
            rank, ok, value = queue.get(timeout=timeout)
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
            results[rank] = pickle.loads(value)
    finally:
        for p in procs:
            p.join(timeout=30)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world)]
