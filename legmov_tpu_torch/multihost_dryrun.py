"""Two-process dry run of the multi-host layer (parallel/multihost.py).

    python -m legmov_tpu_torch.multihost_dryrun [--scale] [--device cpu]

Starts two worker processes that meet through a file store and exercises:

* ``initialize_distributed`` with explicit arguments (``init_method``,
  ``world_size``, ``rank``);
* ``global_pose_batch``: each worker holds only its own half of the pose
  batch, and ``sharded_positionable`` over a mesh whose pose axis spans the
  two processes gathers the quorum;
* ``sharded_positionable`` over a ``(1, 2)`` mesh on the checked poses:
  the footholds split over the two processes and the per-leg OR crosses
  the process boundary.

Each worker holds every result to ``positionable`` in one process on the
same inputs (from the same seed) and the parent prints ``MULTIHOST OK``.
``--scale`` runs BASELINE config 5 at its stated scale: 100,000 body poses,
the hexapod, a quorum of six, 4,096 footholds, checked on a random subsample
of 2,048 poses, and prints each solve's time beside the device's name (and
that of one process alone on the whole batch).  Two
processes on one card, or on one host's CPU, share it: the time checks the
batch shapes and the communication, not multi-card throughput.
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

NPROCS = 2
POSES = 64
FOOTHOLDS = 256
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pose_data(n_poses: int, n_footholds: int, seed: int = 11):
    """``(body [P, 3], footholds [F, 3])``: the draws of the JAX package's
    ``tools/multihost_dryrun.py``."""
    rng = np.random.default_rng(seed)
    body = rng.uniform(-300, 300, (n_poses, 3)).astype(np.float32)
    body[:, 2] = rng.uniform(100, 250, n_poses)
    fh = rng.uniform(-600, 600, (n_footholds, 3)).astype(np.float32)
    fh[:, 2] = rng.uniform(-50, 50, n_footholds)
    return body, fh


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def worker(proc: int, args) -> None:
    from legmov_tpu_torch.models.robot import (
        HEX_MOUNTS,
        get_m2_robot,
        make_robot,
    )
    from legmov_tpu_torch.ops.positionability import positionable
    from legmov_tpu_torch.parallel.multihost import (
        gather_to_host,
        global_pose_batch,
        initialize_distributed,
    )
    from legmov_tpu_torch.parallel.sharding import (
        make_mesh,
        sharded_positionable,
        split_counts,
    )

    device = None if args.device == "cuda" else "cpu"
    if device == "cpu":
        torch.set_num_threads(1)
    initialize_distributed(device, init_method=args.init,
                           world_size=NPROCS, rank=proc)
    import torch.distributed as dist

    try:
        robot = make_robot(HEX_MOUNTS) if args.hex else get_m2_robot()
        body, fh = pose_data(args.poses, args.footholds)
        mesh = make_mesh(points_axis=1, devices=device)
        mesh_or = make_mesh(points_axis=NPROCS, devices=device)
        dev = mesh.device

        # this process's half of the poses only, assembled into the global
        # batch without a gather of the poses
        counts = split_counts(args.poses, NPROCS)
        lo = sum(counts[:proc])
        local = body[lo:lo + counts[proc]]
        shard = global_pose_batch(local, mesh)
        if shard.total != args.poses or shard.offset != lo:
            raise AssertionError(f"global_pose_batch: {shard.offset}, "
                                 f"{shard.counts}")
        sel = np.arange(args.poses)
        if args.check_poses and args.check_poses < args.poses:
            rng = np.random.default_rng(7)
            sel = np.sort(rng.choice(args.poses, args.check_poses,
                                     replace=False))
        # identity orientations, as the JAX tool's (None: one workspace
        # table for every pose); at scale the pose axis is walked in chunks
        # of 1,024 poses
        chunk = 1024 if args.scale else 0
        _sync(dev)
        t0 = time.perf_counter()
        got = sharded_positionable(mesh, k=args.k, chunk=chunk)(
            shard, None, fh, robot)
        _sync(dev)
        t_poses = time.perf_counter() - t0
        # the footholds split over the processes, the OR crosses them: on
        # the checked poses
        t0 = time.perf_counter()
        got_or = sharded_positionable(mesh_or, k=args.k, chunk=chunk)(
            body[sel], None, fh, robot)
        _sync(dev)
        t_or = time.perf_counter() - t0

        def oracle(rows):
            return positionable(torch.from_numpy(body[rows]).to(dev), None,
                                torch.from_numpy(fh).to(dev), robot,
                                k=args.k, chunk=chunk).cpu().numpy()

        # process 0 solves the whole batch alone (its wall is the
        # single-process one), process 1 the checked poses
        t0 = time.perf_counter()
        want = oracle(np.arange(args.poses) if proc == 0 else sel)
        t_single = time.perf_counter() - t0
        want = want[sel] if proc == 0 else want
        np.testing.assert_array_equal(got.cpu().numpy()[sel], want)
        np.testing.assert_array_equal(got_or.cpu().numpy(), want)
        mine = gather_to_host(got[lo:lo + counts[proc]], mesh)
        np.testing.assert_array_equal(mine, got.cpu().numpy())
        where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "the CPU")
        legs = len(np.asarray(robot.body_angle))
        print(f"proc {proc}: rows {lo}..{lo + counts[proc]} of {args.poses} "
              f"from its own pose shard, and the foothold OR across the "
              f"process boundary, equal the single-process result on "
              f"{len(sel)} poses; {args.poses} poses x {args.footholds} "
              f"footholds x {legs} legs: pose-sharded {t_poses:.3f} s, "
              f"foothold-sharded on the {len(sel)} {t_or:.3f} s on {where} "
              "(both processes on "
              "it)" + (f", one process alone {t_single:.3f} s" if proc == 0
                       else "") + "; "
              f"{mesh.stats['collectives'] + mesh_or.stats['collectives']}"
              f" collectives, {mesh.stats['copies'] + mesh_or.stats['copies']}"
              " copies", flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--proc", type=int, default=None)
    ap.add_argument("--init", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--scale", action="store_true",
                    help="BASELINE config-5 scale: 100k poses x hexapod")
    ap.add_argument("--poses", type=int, default=POSES)
    ap.add_argument("--footholds", type=int, default=FOOTHOLDS)
    ap.add_argument("--hex", action="store_true",
                    help="6-leg hexapod instead of the M2 quad")
    ap.add_argument("--k", type=int, default=3)
    ap.add_argument("--check-poses", type=int, default=0,
                    help="verify only a random pose subsample (0 = all)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where both workers compute; cuda needs a card")
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds the workers may take")
    args = ap.parse_args(argv)
    if args.scale:
        args.poses = max(args.poses, 100_000)
        args.footholds = max(args.footholds, 4096)
        args.hex = True
        args.k = 6
        args.check_poses = args.check_poses or 2048
    if args.proc is not None:
        worker(args.proc, args)
        return 0

    from legmov_tpu_torch.config import resolve_device

    resolve_device(None if args.device == "cuda" else "cpu")
    fwd = ["--poses", str(args.poses), "--footholds", str(args.footholds),
           "--k", str(args.k), "--check-poses", str(args.check_poses),
           "--device", args.device] + (["--hex"] if args.hex else [])
    # a SIGTERM ends this process through its ``finally``: the workers go too
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    with tempfile.TemporaryDirectory(prefix="legmov_multihost_") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        procs = []
        try:
            procs += [subprocess.Popen(
                [sys.executable, "-m", "legmov_tpu_torch.multihost_dryrun",
                 "--proc", str(i), "--init", init] + fwd,
                cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True) for i in range(NPROCS)]
            deadline = time.monotonic() + args.timeout
            # a worker that fails ends the run: the other is stopped rather
            # than left waiting in a collective
            while any(p.poll() is None for p in procs):
                if (time.monotonic() > deadline
                        or any(p.returncode not in (None, 0) for p in procs)):
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        ok = True
        for i, p in enumerate(procs):
            out = p.communicate(timeout=60)[0]
            if p.returncode != 0:
                ok = False
                print(f"--- proc {i} rc={p.returncode} ---\n{out}")
            else:
                print(out.strip())
    if not ok:
        return 1
    print("MULTIHOST OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
