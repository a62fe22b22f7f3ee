"""instant-distance-tpu on PyTorch: HNSW build and search on NVIDIA GPUs.

A port of ``instant_distance_tpu`` (JAX/XLA/Pallas) to PyTorch, with the
int8 scan kernels and the packed graph walk written by hand in CUDA for
Hopper (``csrc/``).  The
JAX package stays the reference: the port keeps its public names,
arguments and results, and its tests hold each module against the JAX
function on the same inputs.  It imports nothing of the JAX package.

Every index object lives on the device of the tensors it was built from
(``index.device``); numpy inputs go to the ``device`` argument, the CUDA
card by default (without a card they raise: pass ``device="cpu"`` or
CPU tensors to run on the CPU).  On CPU tensors the kernels run their
plain torch versions.
"""

import torch

from .config import DEFAULT_M, INVALID, Builder, Config, Heuristic

# Full-f32 matrix products, the counterpart of the JAX package's
# Precision.HIGHEST (instant_distance_tpu/ops/distance.py): TF32 rounds
# matmul inputs to 10 mantissa bits, which scrambles near-neighbour
# ordering exactly as bf16 MXU inputs did.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"

__all__ = [
    "Builder",
    "Config",
    "Heuristic",
    "Hnsw",
    "HnswMap",
    "Search",
    "Neighbor",
    "BruteForce",
    "ScanIndex",
    "PackedHnsw",
    "HybridIndex",
    "StreamingHnsw",
    "ShardedHnsw",
    "ShardedScanIndex",
    "ReplicatedHnsw",
    "ReplicatedPackedHnsw",
    "ReplicatedScanIndex",
    "DEFAULT_M",
    "INVALID",
]


def __getattr__(name):
    # Lazy imports, as in instant_distance_tpu/__init__.py.
    if name in ("Hnsw", "HnswMap", "Search", "Neighbor"):
        from .models import hnsw

        return getattr(hnsw, name)
    if name == "BruteForce":
        from .models.brute import BruteForce

        return BruteForce
    if name == "ScanIndex":
        from .models.scan import ScanIndex

        return ScanIndex
    if name == "PackedHnsw":
        from .models.packed import PackedHnsw

        return PackedHnsw
    if name == "HybridIndex":
        from .models.hybrid import HybridIndex

        return HybridIndex
    if name == "StreamingHnsw":
        from .models.streaming import StreamingHnsw

        return StreamingHnsw
    if name == "ShardedHnsw":
        from .parallel.sharded import ShardedHnsw

        return ShardedHnsw
    if name == "ShardedScanIndex":
        from .parallel.scan import ShardedScanIndex

        return ShardedScanIndex
    if name in ("ReplicatedHnsw", "ReplicatedPackedHnsw",
                "ReplicatedScanIndex"):
        from .parallel import replicated

        return getattr(replicated, name)
    raise AttributeError(name)
