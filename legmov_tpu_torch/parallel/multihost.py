"""Multi-process execution on ``torch.distributed``.

The port's mesh is a grid of the ranks of the default process group, one
process a rank (PyTorch's idiom: one process a card).  The pose axis splits
over the ranks with no communication but the result's gather; the foothold
axis can split over a second axis, and the per-leg "any foothold" OR is then
an ``all_reduce`` (parallel/sharding.py).

Backend rule: NCCL when every local rank has a card of its own
(``torch.cuda.device_count() >= LOCAL_WORLD_SIZE``), gloo when ranks share a
card (NCCL refuses two ranks on one device) and for ``device="cpu"``.  Under
gloo every collective takes host tensors; a result computed on a card goes
to the host for the gather and back (``mesh.stats["copies"]`` counts them).

Host data layout: footholds replicated, poses sharded.  Each rank can feed
its own pose chunk through :func:`global_pose_batch`, so that no process
holds the global pose batch.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from legmov_tpu_torch.config import resolve_device

#: seconds a collective (and the rendezvous) waits before the rank fails
TIMEOUT_S = 60.0


def choose_backend(device=None, local_world: int | None = None) -> str:
    """``"nccl"`` when each of ``local_world`` ranks on this host has a card
    of its own, else ``"gloo"`` (always for ``device="cpu"``)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return "gloo"
    if local_world is None:
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    return "nccl" if torch.cuda.device_count() >= local_world else "gloo"


def initialize_distributed(device=None, **kw) -> None:
    """Join a process group (no-op when one is up).

    With keyword arguments (``init_method``, ``world_size``, ``rank``,
    ``backend``, ``timeout``) they are forwarded to
    ``torch.distributed.init_process_group`` and its errors surface; the
    ranks are taken to share this host unless ``LOCAL_WORLD_SIZE`` says
    otherwise.  Without them, ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``) is joined, and with neither this process stays a world
    of one.  ``device`` is where the rank computes (``None`` = the card,
    which must exist; ``"cpu"`` takes gloo).  Prints the backend taken.
    """
    dev = resolve_device(device)
    if dist.is_initialized():
        return
    if not kw and not ("RANK" in os.environ and "WORLD_SIZE" in os.environ):
        return  # a world of one: the sharded functions call straight through
    kw.setdefault("timeout", datetime.timedelta(seconds=TIMEOUT_S))
    if kw.get("init_method") is None:
        kw["init_method"] = "env://"
    world = int(kw.get("world_size", os.environ.get("WORLD_SIZE", 1)))
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if kw.get("backend") is None:
        kw["backend"] = choose_backend(dev, local)
        why = ("every rank has a card of its own" if kw["backend"] == "nccl"
               else "ranks on the CPU" if dev.type != "cuda"
               else f"{local} ranks share {torch.cuda.device_count()} card(s)")
    else:
        why = "asked for"
    dist.init_process_group(**kw)
    if dist.get_rank() == 0:
        print(f"torch.distributed: backend {kw['backend']} ({why}), "
              f"{dist.get_world_size()} ranks", flush=True)


def local_rank() -> int:
    """This process's rank on its host (``LOCAL_RANK``, else the rank)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device(device=None) -> torch.device:
    """The device this rank computes on: ``cuda:{local_rank % cards}``, or
    the CPU when asked for; raises without a card otherwise."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    if dev.index is not None:
        return dev
    return torch.device(f"cuda:{local_rank() % torch.cuda.device_count()}")


class PoseShard(NamedTuple):
    """This rank's rows of a global pose batch that no process holds whole:
    ``local`` on the rank's device, its first row's global index, and the row
    count of every rank in rank order (their sum is the global count)."""

    local: torch.Tensor
    offset: int
    counts: tuple

    @property
    def total(self) -> int:
        return int(sum(self.counts))


def global_pose_batch(local_poses, mesh) -> PoseShard:
    """Each rank passes its own ``[P_local, ...]`` chunk; the global batch is
    the chunks in rank order.  Returns the rank's chunk on its device with
    its global offset and every rank's count, which one collective of one
    integer a rank gathers; the poses themselves are not gathered.  Needs a
    mesh whose pose axis spans every rank (``points_axis=1``)."""
    if mesh.shape[1] != 1:
        raise ValueError("global_pose_batch needs a mesh with points_axis=1")
    local = torch.as_tensor(np.asarray(local_poses)).to(mesh.device)
    n = int(local.shape[0])
    if mesh.size == 1:
        return PoseShard(local, 0, (n,))
    parts = [torch.zeros(1, dtype=torch.int64) for _ in range(mesh.size)]
    dist.all_gather(parts, torch.tensor([n], dtype=torch.int64),
                    group=mesh.host_group)
    mesh.stats["collectives"] += 1
    counts = tuple(int(p) for p in parts)
    return PoseShard(local, int(sum(counts[:mesh.rank])), counts)


def gather_to_host(t, mesh) -> np.ndarray:
    """Every rank's ``[n_r, ...]`` rows, in rank order, as one numpy array on
    every rank (a rank's rows may differ in count)."""
    from legmov_tpu_torch.parallel.sharding import gather_rows

    t = torch.as_tensor(t)
    if mesh.size == 1:
        return t.cpu().numpy()
    counts = [torch.zeros(1, dtype=torch.int64) for _ in range(mesh.size)]
    dist.all_gather(counts, torch.tensor([t.shape[0]], dtype=torch.int64),
                    group=mesh.host_group)
    mesh.stats["collectives"] += 1
    out = gather_rows(mesh, t, [int(c) for c in counts])
    return out.cpu().numpy()


# ---------------------------------------------------------------------------
# starting ranks as new processes
# ---------------------------------------------------------------------------

def _rank_entry(rank, target, world, init_method, device, out_dir, args):
    """One spawned rank: join the group, run ``target(*args)``, write its
    result, leave the group."""
    if torch.device(device or "cuda").type == "cpu":
        torch.set_num_threads(1)  # ranks share the host's cores
    initialize_distributed(device, init_method=init_method, world_size=world,
                           rank=rank)
    try:
        result = target(*args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def run_ranks(target, ranks: int, *args, device=None,
              timeout: float = 600.0) -> list:
    """Run ``target(*args)`` in ``ranks`` new processes that form one
    process group, and return their results in rank order.

    The processes are spawned (CUDA does not survive ``fork``) and meet
    through a file store in a temporary directory.  ``target`` is a
    module-level function of this package (a spawned process imports its
    module).  A rank that raises or exits ends the run: the others are
    stopped and this raises; so does a run that outlasts ``timeout``
    seconds.
    """
    import torch.multiprocessing as mp

    resolve_device(device)
    with tempfile.TemporaryDirectory(prefix="legmov_ranks_") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        ctx = mp.start_processes(
            _rank_entry, args=(target, ranks, init, device, tmp, args),
            nprocs=ranks, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=0.5):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{ranks} ranks did not finish in {timeout:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        out = []
        for r in range(ranks):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out
