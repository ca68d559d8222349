"""``solve_host_syncs.<rule>``: the program's count of host synchronisations
a solve (``stats["host_syncs"]``: one packed fetch a level), as a mean over
the window's solves."""


def read(view):
    if view.kind != "solve" or not view.per_request:
        return None
    n = [r["stats"]["host_syncs"] for r in view.per_request]
    return sum(n) / len(n)
