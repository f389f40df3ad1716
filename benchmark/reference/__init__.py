"""The benchmark's plain reference: what a correct Garage deployment holds
and answers, worked out again from the seeded inputs.

Standard library and NumPy only.  Nothing here imports the program
(``garage_tpu_torch``), the JAX package or JAX, or reads a hash, a
parity piece or a body from the program's state: the drivers hand it
the inputs they generated and the program's outputs to judge.
"""
