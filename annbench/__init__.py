"""The benchmark of the PyTorch and CUDA port (``instant_distance_tpu_torch``):
an index deployment (``configs/``) under a traffic mix (``traffic/``) is
one cell of ``BENCHMARK.json``; ``python3 -m annbench.run`` runs a cell
once.  Nothing here imports JAX or the JAX package."""
