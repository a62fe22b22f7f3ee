"""The JAX package's four examples (``examples/``), written against
``instant_distance_tpu_torch``.  Each runs as a module and takes
``--device`` (the CUDA card by default; ``--device cpu`` asks for the
CPU):

    python -m instant_distance_tpu_torch.examples.colors
    python -m instant_distance_tpu_torch.examples.translate word7_en
    python -m instant_distance_tpu_torch.examples.filtered_serving
    python -m instant_distance_tpu_torch.examples.streaming_ingest
"""
