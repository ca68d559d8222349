"""Multi-rank scaling layer: rank meshes and sharded solvers.

The reference is single-process single-GPU (SURVEY.md section 2.10); its
"scale axis" is the (body-poses x footholds x legs x orientations) product.
Here that product is laid out on a grid of ``torch.distributed`` ranks: the
pose axis is data-parallel across ranks, and the foothold axis can be split
across a second mesh axis with the per-leg OR finished by an ``all_reduce``
(parallel/sharding.py; process groups and rank start-up in
parallel/multihost.py).
"""

from legmov_tpu_torch.parallel.sharding import (
    make_mesh,
    sharded_reachability,
    sharded_distance,
    sharded_positionable,
    sharded_csr_positionable,
    sharded_grid_positionable,
    sharded_cell_eval,
    sharded_csr_cell_eval,
)

__all__ = [
    "make_mesh",
    "sharded_reachability",
    "sharded_distance",
    "sharded_positionable",
    "sharded_csr_positionable",
    "sharded_grid_positionable",
    "sharded_cell_eval",
    "sharded_csr_cell_eval",
]
