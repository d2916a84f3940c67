"""Mesh construction and sharded execution.

Design (scaling-book recipe): pick a 1-D mesh over all cards, shard the
read-batch axis with `P("dp")`, leave every model table replicated, and
let XLA insert any collectives.  Classification needs zero cross-device
communication — reads are independent — so scaling is bounded only by
host IO and batch skew.  The single collective in the whole program is
the global-histogram psum during estimation.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def data_parallel_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), axis_names=("dp",))


def shard_batch(mesh: Mesh, *arrays):
    """Place each (B, ...) array with the leading axis sharded over dp."""
    out = []
    for a in arrays:
        spec = P("dp", *([None] * (np.ndim(a) - 1)))
        out.append(jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec)))
    return out if len(out) > 1 else out[0]


def psum_histogram(mesh: Mesh, local_hist: np.ndarray) -> np.ndarray:
    """All-reduce per-host partial k-mer count histograms.

    Replaces the reference's single-threaded global histogram load
    (process_global_hist, hist.c:28-143) for the distributed setting:
    every host counts its shard of reads, then one psum makes the global
    histogram identical everywhere.

    Multi-process-safe: each process materializes ONLY its addressable
    shards of the (n_devices, H) input (jax.make_array_from_callback);
    the host partial rides on the process's first device row, its other
    rows are zero, so the psum over the dp axis is exactly the sum over
    hosts.  The result is returned fully replicated and fetched as a
    host numpy array."""
    local_hist = np.asarray(local_hist)
    n = mesh.devices.size
    pidx = jax.process_index()
    my_rows = [i for i, d in enumerate(mesh.devices.flat)
               if d.process_index == pidx]
    first_row = min(my_rows) if my_rows else -1
    in_sharding = NamedSharding(mesh, P("dp", *([None] * local_hist.ndim)))

    def _shard(index):
        row = index[0].start or 0
        if row == first_row:
            return local_hist[None].astype(np.int64)
        return np.zeros((1,) + local_hist.shape, np.int64)

    arr = jax.make_array_from_callback((n,) + local_hist.shape,
                                       in_sharding, _shard)

    def _sum(h):
        return jax.lax.psum(h[0], axis_name="dp")

    f = jax.jit(jax.shard_map(
        _sum, mesh=mesh,
        in_specs=P("dp", *([None] * local_hist.ndim)),
        out_specs=P(*([None] * local_hist.ndim))))
    return np.asarray(jax.device_get(f(arr)))


def sharded_classify(mesh: Mesh, fblobs: np.ndarray, iblobs: np.ndarray,
                     PP, dims: tuple):
    """Run the full classification program data-parallel over the mesh.

    fblobs (D, Lf) / iblobs (D, Li): one transfer-blob pair per device
    (each packs that device's read shard — engine.pack_chunk layout);
    dims are the per-shard static dims.  Returns ((D, Bn, max_n) int8,
    (D, Bn) bool exactness-guard flags — reads the caller must
    reclassify with the exact oracle).
    Zero collectives: each device classifies its own shard (the blob
    axis is sharded over dp, so XLA partitions the vmapped program
    one shard per device)."""
    from classpro_tpu.tpu.device_pipeline import classify_batch_dev

    fb = shard_batch(mesh, fblobs)
    ib = shard_batch(mesh, iblobs)

    fn = jax.jit(
        jax.vmap(lambda f, i: classify_batch_dev(f, i, PP, *dims)),
        out_shardings=(NamedSharding(mesh, P("dp", None, None)),
                       NamedSharding(mesh, P("dp", None))))
    return fn(fb, ib)
