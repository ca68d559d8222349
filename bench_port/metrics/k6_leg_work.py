"""``k6_leg_work.<rule>``: how many times the leg pipelines the deepest
level needs K6a or K6b runs: the program's work counter of the leg
pipelines run on elements inside each cell's elongated box
(``per_level[-1]["audit"]["leg_elems_in_box"]``, csrc/cell_kernels.cu
``work``, one a run of ``item_leg``), over the pipelines its inputs need
(``counts/k6.py``: the ``deepest_level`` operations over
``LEG_PIPELINE_OPS``), both as means over the traced solves."""

from bench_port.counts.k6 import LEG_PIPELINE_OPS


def read(view):
    if view.kind != "solve" or "deepest_level" not in view.counts:
        return None
    ran = [r["stats"]["per_level"][-1]["audit"]["leg_elems_in_box"]
           for r in view.per_request
           if r["index"] in view.traced
           and "audit" in r["stats"]["per_level"][-1]]
    need = view.counts["deepest_level"][0] / LEG_PIPELINE_OPS
    if not ran or need <= 0:
        return None
    return sum(ran) / len(ran) / need
