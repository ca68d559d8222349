"""``identity_dispatch_s.<rule>``: the solve's host loop over the levels
above the deepest: the program's own ``per_level[i]["dispatch_s"]`` summed
over them, as a mean per solve over the window's untraced solves. (On the
deepest level that clock also waits on a full launch queue, so it is left
out.)"""


def read(view):
    if view.kind != "solve":
        return None
    sums = [sum(lv["dispatch_s"] for lv in r["stats"]["per_level"][:-1])
            for r in view.per_request if r["index"] not in view.traced]
    return sum(sums) / len(sums) if sums else None
