"""The parallel wrappers of the PyTorch port vs the JAX package.

The JAX side runs on ``default_mesh(4)`` of the eight virtual CPU devices
(tests/conftest.py); the port's on ``default_mesh(devices=["cpu"] * 4)``,
four shards on one device.

* ``ShardedHnsw.build`` at n divisible by 4: gids and shard points
  bit-exact, layer shapes equal, zero-layer edge overlap at least
  ``OVERLAP_FLOOR`` in every shard (the single build's floor,
  tests/test_torch_build.py), recall@10 >= 0.97.
* Search on the JAX-built sharded graph (``sharded_from_arrays``):
  ``ShardedHnsw`` and ``ShardedPackedHnsw``, plain, filtered and after a
  delete, and ``search_batch_values``: ids equal on >= 99% of entries,
  distances within 1e-5 relative where they agree (the single-device
  tolerance: f32 sums in another order, and the JAX search's upper
  descent, which reads its layers bottom first).
* The padded build (4,093 points on 4 shards): the JAX build quantizes
  the last shard's real rows to all-zero codes (recall 0.948, 0.790 over
  the last shard's true neighbours, on this data and config); the port's
  reaches >= 0.99 and >= 0.97, and no real row quantizes to zero.  The
  JAX build also links pad rows into the last shard's graph; the port
  puts them last in the shard's order (shards 0-2 keep the JAX gids)
  and keeps them out of every list, here and in ``dot`` and ``cosine``
  builds of 1,021 points, with the last shard's recall over its true
  neighbours within 0.02 of the other shards' mean.  The padded dump
  loads in the JAX package.
* Checkpoints (tests/test_sharded_checkpoint.py's sizes): a build
  stopped from ``progress`` and resumed equals the uninterrupted one bit
  for bit, the file is gone, and a stale key is ignored.
* Files: a JAX ``dump_sharded`` loads in the port and a port dump in the
  JAX package, with equal searches; a mesh of another size raises.  The
  same both ways for ``ShardedScanIndex`` files.
* ``ShardedScanIndex`` at n not divisible by 4, streamed and
  ``fused=True`` (K2's plain version here, the Pallas kernel in
  interpret mode there), with a filter: ids >= 99%, distances 1e-5.
* ``Replicated*``: each equals the port's single-device index bit for
  bit at a batch divisible by the mesh and one that is not, and matches
  the JAX ``Replicated*`` to the single-device tolerance.
* Two processes, each with ``["cpu"] * 4`` and neither importing jax,
  join a gloo group through ``distributed_mesh``; their ``ShardedHnsw``
  build and search, ``ShardedScanIndex`` and ``ReplicatedHnsw`` equal a
  one-process 8-shard mesh's bit for bit.

:func:`check_cpu` runs inside ``test_scan_path_matches_jax``
(tests/test_torch_scan.py), so the suite collects no new item.
"""

import os
import socket
import subprocess
import sys
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instant_distance_tpu import config as jconfig
from instant_distance_tpu.models.hnsw import Hnsw as JaxHnsw
from instant_distance_tpu.models.packed import PackedHnsw as JaxPackedHnsw
from instant_distance_tpu.models.scan import ScanIndex as JaxScanIndex
from instant_distance_tpu.ops import construct as jconstruct
from instant_distance_tpu.parallel import replicated as jrep
from instant_distance_tpu.parallel.mesh import default_mesh as jax_mesh
from instant_distance_tpu.parallel.scan import (
    ShardedScanIndex as JaxShardedScanIndex)
from instant_distance_tpu.parallel.sharded import ShardedHnsw as JaxSharded
from instant_distance_tpu.utils import serialize as jser
from instant_distance_tpu_torch import config as tconfig
from instant_distance_tpu_torch.models.brute import BruteForce
from instant_distance_tpu_torch.models.hnsw import Hnsw
from instant_distance_tpu_torch.models.packed import PackedHnsw
from instant_distance_tpu_torch.models.scan import ScanIndex
from instant_distance_tpu_torch.ops import construct as tc
from instant_distance_tpu_torch.parallel import replicated as trep
from instant_distance_tpu_torch.parallel.mesh import default_mesh
from instant_distance_tpu_torch.parallel.scan import ShardedScanIndex
from instant_distance_tpu_torch.parallel.sharded import ShardedHnsw
from instant_distance_tpu_torch.utils import serialize as tser
from instant_distance_tpu_torch.utils.convert import sharded_from_arrays
from instant_distance_tpu_torch.utils.metrics import recall_at_k

N, D, Q, S = 2048, 16, 64, 4
KW = dict(seed=11, m=8, wave_size=64, ef_construction=24, ef_search=32,
          construct_mode="scan_fused")
#: The padded build of the motivating measurement: 4 * 1024 - 3 points.
PAD_N = 4093
#: The padded dot and cosine builds: 4 * 256 - 3 points.
PAD_SMALL = 1021
#: Zero-layer edges the port's shard graphs share with the JAX ones
#: (the single build's floor; measured 1.0 in every shard).
OVERLAP_FLOOR = 0.99


def _mesh(n=S):
    return default_mesh(devices=["cpu"] * n)


def _same_mostly(got, want, what):
    """ids equal on >= 99% of entries, distances within 1e-5 relative
    where they are."""
    (gd, gi), (wd, wi) = ([np.asarray(x) for x in r] for r in (got, want))
    assert gi.shape == wi.shape, what
    same = gi == wi
    assert same.mean() >= 0.99, f"{what}: ids agree on {same.mean():.4f}"
    np.testing.assert_allclose(gd[same], wd[same], rtol=1e-5, atol=1e-6,
                               err_msg=what)


def _equal(got, want, what):
    for g, w in zip(got, want):
        assert torch.equal(g, w), what


def _data(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((n, D), dtype=np.float32),
            rng.random((Q, D), dtype=np.float32))


def _recall(found, pts, queries):
    gt = BruteForce(pts, device="cpu").search_batch(queries, 10)[1].numpy()
    return recall_at_k(np.asarray(found), gt, 10), gt


# ---------------------------------------------------------------------------
# ShardedHnsw
# ---------------------------------------------------------------------------

def _check_build(pts, queries):
    """The port's sharded build against the JAX one; returns the JAX
    index (searched and dumped by the checks below)."""
    ref = JaxSharded.build(pts, jconfig.Config(**KW), mesh=jax_mesh(S))
    idx = ShardedHnsw.build(pts, tconfig.Config(**KW), mesh=_mesh())
    points, zero, layers, gids = idx.arrays()
    np.testing.assert_array_equal(gids, np.asarray(ref.gids))
    np.testing.assert_array_equal(points, np.asarray(ref.points))
    assert [l.shape for l in layers] == [l.shape for l in ref.layers]
    ref_zero = np.asarray(ref.zero)
    for s in range(S):
        want = [set(r[r >= 0].tolist()) for r in ref_zero[s]]
        got = [set(r[r >= 0].tolist()) for r in zero[s]]
        share = (sum(len(a & b) for a, b in zip(want, got))
                 / sum(len(a) for a in want))
        assert share >= OVERLAP_FLOOR, (s, share)
    assert len(idx) == N and idx.n_shards == S and idx.reverse_drops == 0
    rec, _ = _recall(idx.search_batch(queries, k=10)[1], pts, queries)
    assert rec >= 0.97, rec
    return ref


def _check_search(ref, queries):
    """Both packages search the JAX-built sharded graph."""
    arrays = (np.asarray(ref.points), np.asarray(ref.zero),
              [np.asarray(l) for l in ref.layers], np.asarray(ref.gids))
    port = sharded_from_arrays(*arrays, tconfig.Config(**KW), _mesh())
    values = [f"v{i}" for i in range(N)]
    ref.values, port.values = values, values
    mask = np.random.default_rng(3).random(N) < 0.6
    for what, kw in (("plain", {}), ("filtered", dict(filter_mask=mask))):
        _same_mostly(port.search_batch(queries, k=10, **kw),
                     ref.search_batch(queries, k=10, **kw), f"sharded {what}")
    _same_mostly(port.pack().search_batch(queries, k=10, ef=32,
                                          filter_mask=mask),
                 ref.pack().search_batch(queries, k=10, ef=32,
                                         filter_mask=mask),
                 "sharded packed filtered")
    dead = np.arange(0, N, 3)
    port.delete(dead)
    ref.delete(dead)
    d, g, vals = port.search_batch_values(queries, k=10)
    rd, rg, rvals = ref.search_batch_values(queries, k=10)
    _same_mostly((d, g), (rd, rg), "sharded after delete")
    assert not np.isin(g.numpy(), dead).any()
    assert vals == [[values[i] for i in row] for row in g.tolist()]
    _same_mostly(port.pack().search_batch(queries, k=10, ef=32),
                 ref.pack().search_batch(queries, k=10, ef=32),
                 "sharded packed after delete")
    ref.values = None
    ref._alive = None
    return port


def _jax_shard_gids(n):
    """The JAX package's shard gids for ``n`` points on S shards, as its
    ``ShardedHnsw.build`` makes them (parallel/sharded.py:126-147)."""
    n_s = -(-n // S)
    perm = np.random.default_rng(KW["seed"]).permutation(n)
    gids = np.concatenate([perm, np.full(S * n_s - n, -1)]).reshape(S, n_s)
    keys = np.random.default_rng(KW["seed"] + 1).integers(0, n_s, size=n_s)
    return gids[:, np.lexsort((np.arange(n_s), keys))]


def _shard_recall(found, gt, gids):
    """recall@10 over the true neighbours that lie in each shard."""
    out = []
    for g in gids:
        inside = np.isin(gt, g)
        out.append(sum(np.isin(gt[r][inside[r]], found[r]).sum()
                       for r in range(len(gt))) / inside.sum())
    return out


def _check_pads_out(idx, pts, queries, metric):
    """The shards of a padded build: shards 0-2 hold the JAX package's
    gids, the last one its real rows in the JAX order and then its 3 pad
    rows; no list links to a pad row and a pad row's lists are empty;
    the last shard's recall is within 0.02 of the others' mean.  Returns
    (found, truth, per-shard recall)."""
    gids = [g.numpy() for g in idx.gids]
    want = _jax_shard_gids(len(pts))
    for j in range(S - 1):
        np.testing.assert_array_equal(gids[j], want[j], err_msg=metric)
    w = want[-1]
    np.testing.assert_array_equal(
        gids[-1], np.concatenate([w[w >= 0], w[w < 0]]), err_msg=metric)
    pads = np.flatnonzero(gids[-1] < 0)
    n_s = len(gids[-1])
    assert pads.tolist() == [n_s - 3, n_s - 2, n_s - 1], (metric, pads)
    for rows in [idx.zero[-1]] + [level[-1] for level in idx.layers]:
        rows = rows.numpy()
        real = gids[-1][:rows.shape[0]] >= 0
        assert not np.isin(rows[real], pads).any(), metric
        assert (rows[~real] == -1).all(), metric
    found = idx.search_batch(queries, k=10)[1].numpy()
    gt = BruteForce(pts, metric=metric, device="cpu").search_batch(
        queries, 10)[1].numpy()
    per = _shard_recall(found, gt, gids)
    assert per[-1] >= np.mean(per[:-1]) - 0.02, (metric, per)
    return found, gt, per


def _check_padded(tmp):
    """The last shard of 4,093 points holds 3 pad rows: the port's scan
    operands leave them out, so its real rows keep their codes; its pad
    rows come last and stay out of the graph, under sqeuclidean and, at
    1,021 points, under dot and cosine.  The padded dump loads in the
    JAX package."""
    rng = np.random.default_rng(0)
    pts = rng.random((PAD_N, D), dtype=np.float32)
    queries = rng.random((256, D), dtype=np.float32)
    idx = ShardedHnsw.build(pts, tconfig.Config(**KW), mesh=_mesh())
    last_pts, last_gids = idx.points[-1], idx.gids[-1]
    real = last_gids >= 0
    assert int((~real).sum()) == 3
    codes_t = tc._quantize_for_scan(last_pts, "sqeuclidean", real)[0]
    codes = codes_t[:, :last_pts.shape[0]].T[real]
    assert bool((codes != 0).any(1).all())
    # the JAX package's operands of the same shard: every real row zero
    jcodes = np.asarray(jconstruct._quantize_for_scan(
        jnp.asarray(last_pts.numpy()), fused=True)[0])
    assert not jcodes[:, :last_pts.shape[0]].T[real.numpy()].any()
    found, gt, per = _check_pads_out(idx, pts, queries, "sqeuclidean")
    rec, last = recall_at_k(found, gt, 10), per[-1]
    assert rec >= 0.99 and last >= 0.97, (rec, last)
    fname = os.path.join(tmp, "padded.npz")
    idx.dump(fname)
    back = jser.load_sharded(fname, mesh=jax_mesh(S))
    np.testing.assert_array_equal(np.asarray(back.gids), idx.arrays()[3])
    for metric in ("dot", "cosine"):
        sub = pts[:PAD_SMALL]
        _check_pads_out(ShardedHnsw.build(
            sub, tconfig.Config(metric=metric, **KW), mesh=_mesh()),
            sub, queries, metric)


class _Stop(RuntimeError):
    pass


def _check_checkpoint(tmp):
    """tests/test_sharded_checkpoint.py's cases on the port, at half its
    points: resume after a stop at wave callback 2 and 5, and a stale
    key."""
    rng = np.random.default_rng(83)
    pts = rng.random((256, 8), dtype=np.float32)
    cfg = tconfig.Config(seed=83, ef_search=32, wave_size=16)
    ref = ShardedHnsw.build(pts, cfg, mesh=_mesh())
    q = rng.random((8, 8), dtype=np.float32)
    for stop_at in (2, 5):
        ckpt = os.path.join(tmp, f"sck{stop_at}.npz")
        calls = []

        def progress(done, total, phase):
            calls.append(done)
            if len(calls) == stop_at:
                raise _Stop()

        with pytest.raises(_Stop):
            ShardedHnsw.build(pts, cfg, mesh=_mesh(), progress=progress,
                              checkpoint=ckpt, checkpoint_every=1)
        assert os.path.exists(ckpt)
        idx = ShardedHnsw.build(pts, cfg, mesh=_mesh(), checkpoint=ckpt,
                                checkpoint_every=1)
        assert not os.path.exists(ckpt)
        _equal(idx.zero + idx.gids, ref.zero + ref.gids, "resumed zero")
        assert len(idx.layers) == len(ref.layers)
        for a, b in zip(idx.layers, ref.layers):
            _equal(a, b, "resumed layers")
        _equal(idx.search_batch(q, k=5), ref.search_batch(q, k=5),
               "resumed search")

    ckpt = os.path.join(tmp, "stale.npz")
    cfg1 = tconfig.Config(seed=89, ef_search=32, wave_size=16,
                          ef_construction=32)

    def stop(done, total, phase):
        if done > 100:
            raise _Stop()

    with pytest.raises(_Stop):
        ShardedHnsw.build(pts, cfg1, mesh=_mesh(), checkpoint=ckpt,
                          checkpoint_every=1, progress=stop)
    assert os.path.exists(ckpt)
    cfg2 = tconfig.Config(seed=90, ef_search=32, wave_size=16,
                          ef_construction=48)
    idx = ShardedHnsw.build(pts, cfg2, mesh=_mesh(), checkpoint=ckpt)
    _equal(idx.zero, ShardedHnsw.build(pts, cfg2, mesh=_mesh()).zero,
           "stale checkpoint")


def _check_files(ref, port, queries, tmp):
    """Sharded files across the two packages."""
    fname = os.path.join(tmp, "jax_sharded.npz")
    jser.dump_sharded(ref, fname)
    loaded = tser.load_sharded(fname, mesh=_mesh())
    fresh = sharded_from_arrays(np.asarray(ref.points), np.asarray(ref.zero),
                                [np.asarray(l) for l in ref.layers],
                                np.asarray(ref.gids), loaded.config, _mesh())
    _equal(loaded.search_batch(queries, k=10),
           fresh.search_batch(queries, k=10), "JAX dump in the port")
    with pytest.raises(ValueError, match="shards"):
        ShardedHnsw.load(fname, mesh=_mesh(2))
    fname = os.path.join(tmp, "port_sharded.npz")
    port.dump(fname)
    back = jser.load_sharded(fname, mesh=jax_mesh(S))
    np.testing.assert_array_equal(np.asarray(back.gids),
                                  np.asarray(ref.gids))
    assert not back._alive[np.arange(0, N, 3)].any()
    port_dead = port.search_batch(queries, k=10)
    _same_mostly(port_dead, back.search_batch(queries, k=10),
                 "port dump in the JAX package")
    _equal(ShardedHnsw.load(fname, mesh=_mesh()).search_batch(queries, k=10),
           port_dead, "port dump in the port")

    pts = np.asarray(ref.points).reshape(-1, D)[:N - 3]
    jscan = JaxShardedScanIndex(pts, mesh=jax_mesh(S))
    jscan.delete([1, 5])
    fname = os.path.join(tmp, "jax_scan.npz")
    jscan.dump(fname)
    scan = ShardedScanIndex.load(fname, mesh=_mesh())
    _same_mostly(scan.search_batch(queries, k=10),
                 jscan.search_batch(queries, k=10), "JAX scan dump")
    fname = os.path.join(tmp, "port_scan.npz")
    scan.dump(fname)
    _same_mostly(scan.search_batch(queries, k=10),
                 JaxShardedScanIndex.load(fname, mesh=jax_mesh(S))
                 .search_batch(queries, k=10), "port scan dump")


# ---------------------------------------------------------------------------
# ShardedScanIndex and the replicated forms
# ---------------------------------------------------------------------------

def _check_sharded_scan(queries):
    """n = 2045 on 4 shards: the last shard holds 3 padding rows."""
    rng = np.random.default_rng(5)
    pts = rng.random((N - 3, D), dtype=np.float32)
    mask = rng.random(N - 3) < 0.7
    for metric, fused in (("sqeuclidean", False), ("euclidean", True),
                          ("cosine", True)):
        ref = JaxShardedScanIndex(pts, metric=metric, mesh=jax_mesh(S))
        port = ShardedScanIndex(pts, metric=metric, mesh=_mesh())
        for fm in (None, mask):
            got = port.search_batch(queries, k=10, fused=fused,
                                    filter_mask=fm)
            _same_mostly(got, ref.search_batch(queries, k=10, fused=fused,
                                               filter_mask=fm),
                         f"sharded scan {metric} fused={fused}")
            if fm is not None:
                assert mask[got[1].numpy()].all()
        assert int(got[1].max()) < N - 3


def _check_replicated(pts, queries):
    """Each replicated form equals the port's single-device index bit
    for bit and the JAX replicated form to the single-device
    tolerance, at a batch of 64 (divisible by the mesh) and 63."""
    cfg_kw = dict(KW, ef_search=24)
    index, _ = Hnsw.build(torch.from_numpy(pts), tconfig.Config(**cfg_kw))
    index.delete([3, 4])
    jindex = JaxHnsw(index.points.numpy(), index.zero.numpy(),
                     [l.numpy() for l in index.layers],
                     jconfig.Config(**cfg_kw))
    jindex.delete([3, 4])
    mask = np.random.default_rng(9).random(N) < 0.8
    # the JAX packed form over the port's packed arrays (pack_layer's
    # parity is tests/test_torch_packed.py's)
    packed = PackedHnsw.from_index(index)
    jpacked = JaxPackedHnsw(
        packed.points.numpy(), [t.numpy() for t in packed.zero_pack],
        [[t.numpy() for t in u] for u in packed.upper_packs],
        jindex.config, alive=jindex._alive)
    scan = ScanIndex(torch.from_numpy(pts), metric="cosine")
    scan.delete([3, 4])
    jscan = JaxScanIndex(pts, metric="cosine")
    jscan.delete([3, 4])
    scan_kw = dict(k=10, ef=32, fused=True, cb=512, lsub=32)
    cases = (
        (trep.ReplicatedHnsw(index, _mesh()), index,
         jrep.ReplicatedHnsw(jindex, jax_mesh(S)), dict(k=10)),
        (trep.ReplicatedPackedHnsw(packed, _mesh()), packed,
         jrep.ReplicatedPackedHnsw(jpacked, jax_mesh(S)), dict(k=10)),
        (trep.ReplicatedScanIndex(scan, _mesh()), scan,
         jrep.ReplicatedScanIndex(jscan, jax_mesh(S)), scan_kw))
    for rep, single, jax_rep, kw in cases:
        what = type(rep).__name__
        single_kw = dict(kw, fused="bucket") if "fused" in kw else kw
        for b in (Q, Q - 1):
            for fm in (None, mask):
                got = rep.search_batch(queries[:b], filter_mask=fm, **kw)
                _equal(got, single.search_batch(queries[:b], filter_mask=fm,
                                                **single_kw), f"{what} B={b}")
        # one JAX call (each batch shape compiles anew): padded, filtered
        jkw = dict(kw, qb=16) if "fused" in kw else kw
        _same_mostly(got, jax_rep.search_batch(
            queries[:Q - 1], filter_mask=mask, **jkw), f"JAX {what}")


# ---------------------------------------------------------------------------
# two processes
# ---------------------------------------------------------------------------

_WORKER = r"""
import sys
sys.modules["jax"] = sys.modules["instant_distance_tpu"] = None
import numpy as np, torch
torch.set_num_threads(1)
from instant_distance_tpu_torch import config
from instant_distance_tpu_torch.parallel import mesh as pm
from instant_distance_tpu_torch.parallel.replicated import ReplicatedHnsw
from instant_distance_tpu_torch.parallel.scan import ShardedScanIndex
from instant_distance_tpu_torch.parallel.sharded import ShardedHnsw
from instant_distance_tpu_torch.models.hnsw import Hnsw

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
if rank >= 0:
    mesh = pm.distributed_mesh(f"127.0.0.1:{port}", 2, rank,
                               devices=["cpu"] * 4)
    assert mesh.size == 8 and mesh.world == 2
else:
    mesh = pm.default_mesh(devices=["cpu"] * 8)
rng = np.random.default_rng(5)
pts = rng.random((1021, 8), dtype=np.float32)
q = rng.random((30, 8), dtype=np.float32)
cfg = config.Config(seed=5, m=8, ef_search=16, ef_construction=16,
                    wave_size=32, construct_mode="scan_fused")
idx = ShardedHnsw.build(pts, cfg, mesh=mesh)
idx.delete([1, 2])
single, _ = Hnsw.build(torch.from_numpy(pts), cfg)
res = dict(
    points=idx.arrays()[0], zero=idx.arrays()[1], gids=idx.arrays()[3],
    search=idx.search_batch(q, k=8)[1].numpy(),
    packed=idx.pack().search_batch(q, k=8)[1].numpy(),
    scan=ShardedScanIndex(pts, mesh=mesh).search_batch(q, k=8)[1].numpy(),
    repl=ReplicatedHnsw(single, mesh).search_batch(q, k=8)[1].numpy(),
    n=np.array(len(idx)))
for i, level in enumerate(idx.arrays()[2]):
    res[f"layer_{i}"] = level
loaded = {m.split(".")[0] for m in sys.modules if sys.modules[m] is not None}
assert not loaded & {"jax", "instant_distance_tpu"}, loaded
np.savez(out, **res)
if rank >= 0:
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
print(f"worker {rank}: ok", flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _check_two_processes(tmp):
    script = os.path.join(tmp, "worker.py")
    with open(script, "w") as f:
        f.write(_WORKER)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1")
    port = str(_free_port())
    outs = {r: os.path.join(tmp, f"rank{r}.npz") for r in (-1, 0, 1)}
    procs = {r: subprocess.Popen([sys.executable, script, str(r), port,
                                  outs[r]], env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for r in (0, 1, -1)}
    logs = {}
    try:
        for r, p in procs.items():
            logs[r] = p.communicate(timeout=120)[0]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    for r, p in procs.items():
        assert p.returncode == 0 and f"worker {r}: ok" in logs[r], \
            logs[r][-3000:]
    one = np.load(outs[-1])
    for r in (0, 1):
        with np.load(outs[r]) as z:
            for key in z.files:
                want = one[key]
                if key not in ("search", "packed", "scan", "repl", "n"):
                    want = want[4 * r:4 * r + 4]       # this rank's shards
                np.testing.assert_array_equal(z[key], want,
                                              err_msg=f"rank {r} {key}")


def check_cpu():
    pts, queries = _data(N, 11)
    ref = _check_build(pts, queries)
    port = _check_search(ref, queries)
    _check_sharded_scan(queries)
    _check_replicated(pts, queries)
    with tempfile.TemporaryDirectory() as tmp:
        _check_padded(tmp)
        _check_checkpoint(tmp)
        _check_files(ref, port, queries, tmp)
        _check_two_processes(tmp)
