"""What the deepest octree level needs: the work behind ``k6b_roofline``
and ``k6a_roofline``.

At the deepest level every cell samples the configuration's orientations.
For a cell, an orientation and a leg, a foothold farther from the leg's
coxa joint than the leg's full reach plus the cell's crossing radius can
be neither reached nor crossing, so only the footholds inside that ball
need the leg's pipeline (un-rotation, the distance to the workspace, the
crossing test).  A cell needs the orientations up to the one after which
its flags can no longer change, in the configuration's sample order; under
the per-leg rule a leg already decided under an orientation needs one
pipeline there.  The reference counts this on a seeded sample of the
level's cells (``solve_ref.eval_cells``) and scales it to all of them:
the count depends on the terrain, the robot, the configuration and the
level's cells, and on no solver setting.
"""

#: float32 operations of one leg pipeline on one (cell, orientation,
#: foothold): mount yaw, coxa frame and heading 20; both finish branches of
#: the distance to the workspace 2 x 387; branch select, un-pitch, un-yaw,
#: body rotation and the crossing tests 66 (counted from the kernel source,
#: selects and boolean logic not counted).
LEG_PIPELINE_OPS = 20 + 2 * 387 + 66
#: bytes of one foothold (x, y, z float32), read once
FOOTHOLD_BYTES = 12
#: bytes of one cell: its centre and parent flag in, three flags out
CELL_BYTES = 12 + 1 + 3


def deepest_level(pipelines: float, cells: int, footholds: int):
    """``(operations, bytes)`` the deepest level needs for ``pipelines``
    leg pipelines over ``cells`` cells and ``footholds`` footholds."""
    return (pipelines * LEG_PIPELINE_OPS,
            footholds * FOOTHOLD_BYTES + cells * CELL_BYTES)
