"""``map_poses_per_s``: how fast a map builder gets a body map decided: the
body candidates of the window's completed requests over their summed wall
(host clock, from the candidates handed over to the feasible mask on the
host)."""


def read(view):
    if view.kind != "map":
        return None
    ok = {r.index: r.end - r.start for r in view.requests if r.ok}
    poses = sum(r["poses"] for r in view.per_request if r["index"] in ok)
    wall = sum(ok[r["index"]] for r in view.per_request if r["index"] in ok)
    return poses / wall if wall > 0 else None
