"""``deepest_host_s.<rule>``: the host seconds of the deepest level's steps
that launch nothing, so that no full launch queue stretches them: the
program's own clocks (``per_level[-1]["host_s"]``) of ``level.split``,
``level.tables``, ``batch.queue_max`` and ``level.unpack``, as a mean per
solve over the window's untraced solves."""

PHASES = ("level.split", "level.tables", "batch.queue_max", "level.unpack")


def read(view):
    if view.kind != "solve":
        return None
    sums = [sum(r["stats"]["per_level"][-1]["host_s"].get(p, 0.0)
                for p in PHASES)
            for r in view.per_request
            if r["index"] not in view.traced
            and "host_s" in r["stats"]["per_level"][-1]]
    return sum(sums) / len(sums) if sums else None
