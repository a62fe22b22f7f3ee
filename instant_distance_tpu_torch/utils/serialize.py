"""Index persistence: the native .npz format and the reference's bincode
(the port's own copy of ``instant_distance_tpu/utils/serialize.py``).

The files are the JAX package's, byte for byte in the arrays they hold,
so an index dumped by either package loads in the other.  The bincode
layout is the reference binding's serde stream (instant-distance-py
src/lib.rs:59-75; bincode 1.3 legacy config: little endian, fixed-width
ints, u64 lengths):

    HnswMap {
      hnsw: Hnsw {
        ef_search: u64,
        points:  Vec<FloatArray>,       # u64 len + n * D * f32
        zero:    Vec<ZeroNode>,         # u64 len + n * (2M * u32)
        layers:  Vec<Vec<UpperNode>>,   # u64 len + per layer: u64 len +
                                        # rows * (M * u32)
      },
      values: Vec<MapValue>,            # u64 len + per value: u32 tag
                                        # (0 = String) + u64 len + utf8
    }

INVALID is u32::MAX, int32 -1 bit for bit, so adjacency round-trips by a
uint32 <-> int32 view.

Loading builds the index on ``device`` (default: the CUDA card; without
one it raises, so pass ``device="cpu"`` for the CPU).
"""

from __future__ import annotations

import dataclasses
import json
import struct
import warnings
from typing import Optional

import numpy as np
import torch

from ..config import Config, Heuristic

_MAGIC = "instant-distance-tpu/v1"
_MAGIC_SCAN = "instant-distance-tpu/scan/v1"

#: The reference binding's fixed dimensionality (py src/lib.rs:448).
REFERENCE_DIMS = 300


# ---------------------------------------------------------------------------
# native npz
# ---------------------------------------------------------------------------

def _config_to_json(cfg: Config) -> str:
    d = dataclasses.asdict(cfg)
    if not isinstance(d.get("metric"), str):
        d["metric"] = "custom"  # callables can't be serialized
    return json.dumps(d)


def _config_from_json(s: str) -> Config:
    d = json.loads(s)
    h = d.pop("heuristic", None)
    cfg = Config(**{k: v for k, v in d.items()
                    if k in {f.name for f in dataclasses.fields(Config)}})
    cfg.heuristic = Heuristic(**h) if h is not None else None
    return cfg


def _np(x, dtype):
    """A tensor (any device, bfloat16 included) or array as numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        x = (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x, dtype)


def dump_native(index, fname: str) -> None:
    arrays = {
        "magic": np.array(_MAGIC),
        "config": np.array(_config_to_json(index.config)),
        "points": _np(index.points, np.float32),
        "zero": _np(index.zero, np.int32),
        "n_layers": np.array(len(index.layers), np.int64),
    }
    for i, layer in enumerate(index.layers):
        arrays[f"layer_{i}"] = _np(layer, np.int32)
    values = getattr(index, "values", None)
    if values is not None:
        arrays["values"] = np.array(json.dumps(list(values)))
    alive = getattr(index, "_alive", None)
    if alive is not None:
        arrays["alive"] = _np(alive, bool)
    with open(fname, "wb") as f:
        np.savez(f, **arrays)


def load_native(fname: str, device=None):
    from ..models.hnsw import Hnsw, HnswMap
    from .convert import as_tensor

    with np.load(fname, allow_pickle=False) as z:
        magic = str(z["magic"]) if "magic" in z.files else ""
        if magic == _MAGIC_SCAN:
            from ..models.scan import ScanIndex

            return ScanIndex.load(fname, device=device)
        if magic != _MAGIC:
            raise ValueError(f"{fname}: not an instant-distance-tpu index")
        cfg = _config_from_json(str(z["config"]))
        points = as_tensor(z["points"], device)
        zero = z["zero"]
        layers = [z[f"layer_{i}"] for i in range(int(z["n_layers"]))]
        alive = z["alive"] if "alive" in z.files else None
        if "values" in z.files:
            values = json.loads(str(z["values"]))
            idx = HnswMap(points, zero, layers, cfg, values)
        else:
            idx = Hnsw(points, zero, layers, cfg)
        if alive is not None:
            idx._alive = as_tensor(alive, idx.device)
        return idx


# ---------------------------------------------------------------------------
# bincode (reference cross-validation format)
# ---------------------------------------------------------------------------

def _w_u64(f, v: int) -> None:
    f.write(struct.pack("<Q", v))


class _BincodeReader:
    """Bounds-checked cursor over a bincode byte buffer.

    The format has no magic or checksum, so the only defence against a
    truncated or corrupt file is strict accounting: every read states
    what it is for and fails with a position-annotated ValueError."""

    def __init__(self, data: bytes, fname: str):
        self.data = data
        self.off = 0
        self.fname = fname

    def take(self, nbytes: int, what: str) -> bytes:
        if nbytes < 0 or self.off + nbytes > len(self.data):
            raise ValueError(
                f"{self.fname}: truncated or corrupt bincode — needed "
                f"{nbytes} bytes for {what} at offset {self.off}, file "
                f"has {len(self.data)}")
        out = self.data[self.off:self.off + nbytes]
        self.off += nbytes
        return out

    def u64(self, what: str) -> int:
        return struct.unpack("<Q", self.take(8, what))[0]

    def u32(self, what: str) -> int:
        return struct.unpack("<I", self.take(4, what))[0]

    def count(self, what: str, elem_bytes: int) -> int:
        """A u64 length whose payload must fit in the remaining bytes."""
        n = self.u64(what)
        if elem_bytes and n > (len(self.data) - self.off) // elem_bytes:
            raise ValueError(
                f"{self.fname}: corrupt bincode — {what} claims {n} "
                f"elements ({n * elem_bytes} bytes) but only "
                f"{len(self.data) - self.off} bytes remain")
        return n

    def array(self, n: int, dtype: str, shape, what: str) -> np.ndarray:
        itemsize = np.dtype(dtype).itemsize
        raw = self.take(n * itemsize, what)
        return np.frombuffer(raw, dtype).reshape(shape)

    @property
    def remaining(self) -> int:
        return len(self.data) - self.off


def dump_bincode(index, fname: str) -> None:
    """Write the reference's bincode layout (readable by the Rust crate
    when D == 300 and M == 32; other shapes warn, and load back only
    through :func:`load_bincode` with matching ``dims``/``m``)."""
    points = _np(index.points, np.float32)
    if points.shape[1] != REFERENCE_DIMS or index.config.m != 32:
        warnings.warn(
            f"bincode dump with D={points.shape[1]}, M={index.config.m}: "
            "the Rust reference binding only reads D=300, M=32 "
            "(instant-distance-py/src/lib.rs:448); this dump is readable "
            "only by load_bincode with matching dims/m.",
            stacklevel=2)
    zero = _np(index.zero, np.int32).astype(np.uint32)
    layers = [_np(l, np.int32).astype(np.uint32) for l in index.layers]
    with open(fname, "wb") as f:
        _w_u64(f, index.config.ef_search)
        _w_u64(f, len(points))
        f.write(points.astype("<f4").tobytes())
        _w_u64(f, len(zero))
        f.write(zero.astype("<u4").tobytes())
        _w_u64(f, len(layers))
        for layer in layers:
            _w_u64(f, len(layer))
            f.write(layer.astype("<u4").tobytes())
        values = getattr(index, "values", None)
        if values is not None:
            _w_u64(f, len(values))
            for v in values:
                f.write(struct.pack("<I", 0))  # MapValue::String tag
                data = str(v).encode("utf-8")
                _w_u64(f, len(data))
                f.write(data)


def load_bincode(fname: str, dims: int = REFERENCE_DIMS, m: int = 32,
                 config: Optional[Config] = None,
                 has_values: Optional[bool] = None, device=None):
    """Read a reference bincode dump.  ``dims`` must match the writer
    (the format has no header); ``has_values`` None detects values by
    trailing bytes.  Truncated or corrupt input fails with a
    position-annotated ValueError before any large allocation."""
    from ..models.hnsw import Hnsw, HnswMap
    from .convert import as_tensor

    with open(fname, "rb") as fh:
        data = fh.read()
    r = _BincodeReader(data, fname)
    ef_search = r.u64("ef_search")
    n = r.count("point count", dims * 4)
    points = r.array(n * dims, "<f4", (n, dims), "points")
    nz = r.count("zero-layer row count", 2 * m * 4)
    if nz != n:
        raise ValueError(
            f"{fname}: zero rows {nz} != point count {n} — wrong "
            f"dims/m for this dump, or corrupt file")
    zero = r.array(n * 2 * m, "<u4", (n, 2 * m), "zero layer").view(
        np.int32)
    nl = r.count("layer count", 8)
    layers = []
    for li in range(nl):
        rows = r.count(f"layer {li} row count", m * 4)
        layers.append(r.array(rows * m, "<u4", (rows, m),
                              f"layer {li}").view(np.int32))
    if has_values is None:
        has_values = r.remaining > 0
    cfg = config or Config(ef_search=ef_search, m=m)
    cfg.ef_search = ef_search
    points = as_tensor(points, device)
    if not has_values:
        if r.remaining:
            raise ValueError(
                f"{fname}: {r.remaining} trailing bytes after the graph "
                "— dims/m mismatch with the writer, or corrupt file")
        return Hnsw(points, zero, layers, cfg)
    values = []
    count = r.count("value count", 4)
    for vi in range(count):
        tag = r.u32(f"value {vi} tag")
        if tag != 0:
            raise ValueError(
                f"{fname}: unknown MapValue variant {tag} at value {vi} "
                f"(offset {r.off - 4})")
        ln = r.count(f"value {vi} length", 1)
        try:
            values.append(r.take(ln, f"value {vi} bytes").decode("utf-8"))
        except UnicodeDecodeError as exc:
            raise ValueError(
                f"{fname}: value {vi} is not valid UTF-8: {exc}") from exc
    if count != n:
        raise ValueError(
            f"{fname}: {count} values for {n} points — corrupt file or "
            "a non-map dump read with has_values=True")
    if r.remaining:
        raise ValueError(
            f"{fname}: {r.remaining} trailing bytes after the values — "
            "dims/m mismatch with the writer, or corrupt file")
    return HnswMap(points, zero, layers, cfg, values)


# ---------------------------------------------------------------------------
# sharded npz
# ---------------------------------------------------------------------------

_MAGIC_SHARDED = "instant-distance-tpu/sharded-v1"


def dump_sharded(index, fname: str) -> None:
    """Persist a ShardedHnsw: all shards' graph arrays in one npz, with a
    leading shard axis (the JAX package's ``sharded-v1`` file, so either
    package loads the other's).  A rank of a distributed mesh holds only
    its own shards, so only a one-process mesh dumps."""
    if index.mesh.world > 1:
        raise ValueError("dump needs every shard in this process")
    points, zero, layers, gids = index.arrays()
    arrays = {
        "magic": np.array(_MAGIC_SHARDED),
        "config": np.array(_config_to_json(index.config)),
        "points": points,                                 # [S, n_s, D]
        "zero": zero,                                     # [S, n_s, m0]
        "gids": gids,                                     # [S, n_s]
        "n_layers": np.array(len(layers), np.int64),
        "reverse_drops": np.array(int(index.reverse_drops), np.int64),
    }
    for i, layer in enumerate(layers):
        arrays[f"layer_{i}"] = layer
    if index.values is not None:
        arrays["values"] = np.array(json.dumps(list(index.values)))
    if index._alive is not None:
        arrays["alive"] = _np(index._alive, bool)
    with open(fname, "wb") as f:
        np.savez(f, **arrays)


def load_sharded(fname: str, mesh=None):
    """Load a ShardedHnsw dump onto ``mesh`` (default: the first S CUDA
    cards, S the dump's shard count).  The shard count is baked into the
    arrays: re-sharding is a rebuild, and a mesh of another size
    raises."""
    from ..parallel.mesh import default_mesh
    from ..parallel.sharded import ShardedHnsw
    from .convert import as_tensor

    with np.load(fname, allow_pickle=False) as z:
        if str(z["magic"]) != _MAGIC_SHARDED:
            raise ValueError(
                f"{fname}: not a sharded instant-distance-tpu index")
        cfg = _config_from_json(str(z["config"]))
        points = z["points"]
        s = points.shape[0]
        if mesh is None:
            mesh = default_mesh(s)
        elif mesh.size != s:
            raise ValueError(
                f"dump has {s} shards but mesh has {mesh.size} devices; "
                "re-sharding requires a rebuild")
        layers = [z[f"layer_{i}"] for i in range(int(z["n_layers"]))]
        values = (json.loads(str(z["values"]))
                  if "values" in z.files else None)
        idx = ShardedHnsw(points, z["zero"], layers, z["gids"], cfg, mesh,
                          values=values)
        if "alive" in z.files:
            idx._alive = as_tensor(z["alive"], mesh.first, torch.bool)
        idx.reverse_drops = int(z["reverse_drops"])
        return idx


# ---------------------------------------------------------------------------
# front door
# ---------------------------------------------------------------------------

def dump(index, fname: str, format: str = "native") -> None:
    if format == "native":
        dump_native(index, fname)
    elif format == "bincode":
        dump_bincode(index, fname)
    else:
        raise ValueError(f"unknown format {format!r}")


def load(fname: str, format: str = "auto", device=None, **kw):
    """Load an index file on ``device`` (default: the CUDA card)."""
    if format == "auto":
        with open(fname, "rb") as f:
            head = f.read(4)
        format = "native" if head.startswith(b"PK") else "bincode"
    if format == "native":
        return load_native(fname, device=device)
    if format == "bincode":
        return load_bincode(fname, device=device, **kw)
    raise ValueError(f"unknown format {format!r}")
