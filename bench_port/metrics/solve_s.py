"""``solve_s.<rule>``: a planner's wait for a whole positionability octree:
the summed wall of the solves completed in the window over their count
(host clock, from the terrain handed over to the ``CellRecord`` on the
host). Each foothold rule has a metric of its own, and so a bound of its
own: their runs spread 1.3 % and 5.4 %, so one bound would hide a
shared-rule loss of up to 25 %."""


def read(view):
    walls = [r.end - r.start for r in view.requests if r.ok]
    if view.kind != "solve" or not walls:
        return None
    return sum(walls) / len(walls)
