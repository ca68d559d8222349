"""The plain reference that decides ``correct``.

Plain PyTorch and numpy, run after the measured window: it imports nothing
of the program (``legmov_tpu_torch``) nor the JAX package, and it takes
nothing the program made.  From the inputs the harness generated (terrains,
the configuration) it works out again whatever the program derived,
and it reads the program's outputs only to judge them.
"""
