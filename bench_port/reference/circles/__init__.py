"""A frozen copy of the port's plain circle math.

These modules are copies of the port's plain PyTorch formulation of the
reference robot model: the leg parameters (``leg.py``, ``robot.py``), the
circle-decomposition workspace (``workspace.py``, ``plane.py``), float32
trigonometry with fixed bits on every device (``trig32.py``), quaternions,
frames, single-leg reachability and distance, and the body-orientation
layer (``orientation.py``).  Only their imports were made relative.  They
are kept here, beside the benchmark, so that a later change to the program
cannot move the yardstick it is judged by.
"""
