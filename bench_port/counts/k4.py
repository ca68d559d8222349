"""What a map request needs: the work behind ``k4_roofline``.

A request decides each of its body positions under the sweep's
orientations, in the sweep's order, up to the first at which the position
stands (the sweep's own stopping rule; a position that never stands takes
every orientation).  With the quorum ``k`` equal to the leg count ``L``,
every exact method has to do at least this:

* at the orientation where a position stands, prove each leg: at least one
  candidate un-rotated (``UNROTATE_OPS``) and each of the ``L`` legs tested
  on a candidate it reaches (``LEG_OPS`` a leg), since no leg's answer
  follows from another's;
* at an orientation where it does not stand, prove one leg fails: a leg
  fails only if none of the footholds inside its reach ball (the ball of
  radius coxa + femur + tibia about its rotated coxa joint, outside which
  no foothold is reached) is reached, so each of them takes the leg's test
  (``UNROTATE_OPS + LEG_OPS``).  The count takes the failing leg with the
  fewest footholds in its ball, the least any method can get away with.

Only the reach ball is granted as a free prune: a kernel that rejected
footholds inside a ball by an exact test cheaper than the leg's own would
need less than this count, and its share of the roofline could pass 100 %.
The costs are those of K3 and K4 (``cuda_multileg.UNROTATE_FLOPS`` 33 a
candidate, ``leg_flops`` 84 a leg for the M2 leg: selects and boolean
logic not counted).

Bytes: each foothold that some failing leg's ball of a counted position
holds is read once (12 B), each position once (12 B) and each answer
written once (1 B).  The operations are counted on a seeded sample of the
request's positions and scaled to all of them; the footholds read are the
sample's, a subset of the request's, so the bytes stay a lower bound too.
The count depends on the terrain, the robot, the sweep and the request's
positions, and on no solver setting (window, rounds, pose chunk).
"""

from __future__ import annotations

import numpy as np
import torch

#: float32 operations to un-rotate one candidate into the body frame
UNROTATE_OPS = 33
#: float32 operations of one leg's reachability test on one candidate
LEG_OPS = 84
#: bytes of one foothold or one position (x, y, z float32), and of an answer
POINT_BYTES = 12
ANSWER_BYTES = 1


def request_need(ev, k: int, positions: int):
    """``(operations, bytes)`` a request of ``positions`` body positions
    needs, from the reference's evaluation ``ev`` (``map_ref.MapEval``) of
    a sample of them at quorum ``k``."""
    n, S, L = ev.legs.shape
    if k != L:
        raise ValueError("the count covers a quorum of every leg only")
    if n == 0:
        return 0.0, float(positions * (POINT_BYTES + ANSWER_BYTES))
    dev = ev.valid.device
    ops = 0.0
    read = torch.zeros(ev.valid.shape, dtype=torch.bool, device=dev)
    big = np.iinfo(np.int64).max
    for s in range(S):
        counted = ev.first >= s  # the sweep still decides these at s
        failing = counted & (ev.first != s)
        ops += float(np.sum(counted & ~failing)) * (UNROTATE_OPS + L * LEG_OPS)
        if not failing.any():
            continue
        cost = np.where(~ev.legs[:, s, :], ev.in_ball[:, s, :], big)
        leg = cost.argmin(axis=1)
        ops += float(cost[failing, leg[failing]].sum()) * (UNROTATE_OPS
                                                          + LEG_OPS)
        rows = torch.from_numpy(failing).to(dev)
        read |= ev.ball(s, torch.from_numpy(leg).to(dev)) & rows[:, None]
    footholds = int(torch.unique(ev.idx[read]).numel())
    return (ops * positions / n,
            float(footholds * POINT_BYTES
                  + positions * (POINT_BYTES + ANSWER_BYTES)))
