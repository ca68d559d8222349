from legmov_tpu_torch.ops.reachability import reachability, reachability_batch
from legmov_tpu_torch.ops.distance import distance, distance_batch
from legmov_tpu_torch.ops.orientation import (
    rotate_leg_data,
    reachability_oriented,
    distance_oriented,
    distance_oriented_grav,
    gravity_check,
)
from legmov_tpu_torch.ops.positionability import (
    reachable_legs,
    reachable_leg_counts,
    positionable,
    positionable_batch,
)
from legmov_tpu_torch.ops.collision import (
    in_sphere,
    any_in_sphere,
    in_cylinder,
    any_in_cylinder,
)
from legmov_tpu_torch.ops.grid import (
    FootholdGrid,
    build_grid,
    cell_size_for,
    neighbor_offsets,
    grid_reachable_legs,
    grid_reachable_legs_topk,
)

__all__ = [
    "reachability",
    "reachability_batch",
    "distance",
    "distance_batch",
    "rotate_leg_data",
    "reachability_oriented",
    "distance_oriented",
    "distance_oriented_grav",
    "gravity_check",
    "reachable_legs",
    "reachable_leg_counts",
    "positionable",
    "positionable_batch",
    "in_sphere",
    "any_in_sphere",
    "in_cylinder",
    "any_in_cylinder",
    "FootholdGrid",
    "build_grid",
    "cell_size_for",
    "neighbor_offsets",
    "grid_reachable_legs",
    "grid_reachable_legs_topk",
]
