"""The plain reference that decides ``correct``.

Plain PyTorch, float32 with TF32 off, written from the published
descriptions (DIB-R: Chen et al. 2019; the SPC octree and its ray trace:
Takikawa et al. 2021 and kaolin's documentation).  Nothing here imports the
program (``kaolin_tpu_torch``) or the JAX package, and nothing takes what
the program made: every octree, cell, target and parameter the comparison
needs is worked out again from the cell's inputs.  Each function takes a
``dtype`` so that the same code in a lower precision is the control that a
comparison must fail.
"""
