"""Multi-chip scale-out: shard loci and read batches over a device mesh.

The reference is single-node: a serial per-locus loop
(genome_analyzer.py:280-297) with per-read multiprocessing only on the
PacBio path (vntr_finder.py:424-439).  Here the layout is:

- ``loci`` mesh axis: each shard owns a slice of the locus panel — the
  stacked model tensors (log_T, log_E, ...) live sharded in device memory,
  so a panel of G compiled loci occupies G/n_loci of each device's memory
- ``reads`` mesh axis: each locus's candidate read batch is data-parallel

Per-read results are independent (no cross-read reduction), so the only
communication is the final gather of per-read scalars to the host — the
embarrassingly-parallel best case for the device interconnect.
"""

from __future__ import annotations

import functools
import math

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from advntr_tpu.engine import device_analytics as da


def make_mesh(n_loci: int = 1, n_reads: int | None = None,
              devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    n_total = len(devices)
    if n_reads is None:
        n_reads = n_total // n_loci
    assert n_loci * n_reads == n_total, "mesh must use all devices"
    dev_array = np.array(devices).reshape(n_loci, n_reads)
    return Mesh(dev_array, ("loci", "reads"))


def stack_models(models: list[da.DeviceModel]):
    """Stack G same-shape DeviceModels into one pytree with a leading locus
    axis (padding buckets guarantee equal shapes within a bucket)."""
    flats = [m.flat() for m in models]
    return tuple(jnp.stack([f[i] for f in flats]) for i in range(len(flats[0])))


@functools.partial(jax.jit, static_argnames=("mesh",))
def _sharded_multi_locus_stats(mesh, stacked_models, seqs, lengths):
    in_specs = (
        tuple(P("loci") for _ in stacked_models),  # models sharded over loci
        P("loci", "reads", None),                  # (G, B, L) reads
        P("loci", "reads"),                        # (G, B)
    )

    def per_locus(models, s, l):
        return da.read_stats(models, s, l)

    vmapped = jax.vmap(per_locus, in_axes=(0, 0, 0))
    return jax.shard_map(
        lambda m, s, l: vmapped(m, s, l),
        mesh=mesh,
        in_specs=in_specs,
        out_specs=P("loci", "reads"),
    )(stacked_models, seqs, lengths)


def multi_locus_read_stats(mesh: Mesh, stacked_models, seqs, lengths):
    """Fused Viterbi+analytics for G loci x B reads, sharded over the mesh.

    seqs: (G, B, L) int8; lengths: (G, B) int32.  G must divide by the
    ``loci`` axis size and B by the ``reads`` axis size.
    Returns dict of (G, B) arrays.
    """
    g_axis = mesh.shape["loci"]
    r_axis = mesh.shape["reads"]
    G, B, L = seqs.shape
    assert G % g_axis == 0, (G, g_axis)
    assert B % r_axis == 0, (B, r_axis)
    sharding_models = tuple(
        jax.device_put(m, NamedSharding(mesh, P("loci")))
        for m in stacked_models)
    seqs = jax.device_put(jnp.asarray(seqs),
                          NamedSharding(mesh, P("loci", "reads", None)))
    lengths = jax.device_put(jnp.asarray(lengths),
                             NamedSharding(mesh, P("loci", "reads")))
    return _sharded_multi_locus_stats(mesh, sharding_models, seqs, lengths)


@functools.partial(jax.jit, static_argnames=("mesh",))
def _sharded_grouped_stats(mesh, stacked_struct, stacked_meta, seqs,
                           lengths, suffix_lasts):
    in_specs = (
        tuple(P("loci") for _ in stacked_struct),
        tuple(P("loci") for _ in stacked_meta),
        P("loci", "reads", None),
        P("loci", "reads"),
        P("loci"),
    )
    return jax.shard_map(
        da.read_stats_struct_grouped,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=P("loci", "reads"),
    )(stacked_struct, stacked_meta, seqs, lengths, suffix_lasts)


def sharded_grouped_read_stats(mesh: Mesh, stacked_struct, stacked_meta,
                               seqs, lengths, suffix_lasts=None):
    """PRODUCTION multi-device dispatch: the same grouped fused
    Viterbi+analytics executable the single-device analyzer runs
    (da.read_stats_struct_grouped), sharded loci x reads.

    Each device owns G/n_loci locus models and scores B/n_reads reads per
    locus; per-read outputs are independent, so the only collective is
    the output all-gather XLA inserts for the host fetch.  Replaces the
    reference's serial per-locus loop (genome_analyzer.py:280-297) at
    scale-out.

    stacked_struct: per-field stacks of StructDeviceModel.flat() with a
    leading locus axis (G, ...).
    seqs: (G, B, L); lengths: (G, B); suffix_lasts: (G,).
    Returns dict of (G, B) arrays.
    """
    g_axis = mesh.shape["loci"]
    r_axis = mesh.shape["reads"]
    G, B, L = seqs.shape
    assert G % g_axis == 0, (G, g_axis)
    assert B % r_axis == 0, (B, r_axis)
    if suffix_lasts is None:
        suffix_lasts = np.zeros(G, dtype=np.int32)
    put = jax.device_put
    stacked_struct = tuple(
        put(m, NamedSharding(mesh, P("loci"))) for m in stacked_struct)
    stacked_meta = tuple(
        put(m, NamedSharding(mesh, P("loci"))) for m in stacked_meta)
    seqs = put(jnp.asarray(seqs), NamedSharding(mesh, P("loci", "reads",
                                                        None)))
    lengths = put(jnp.asarray(lengths), NamedSharding(mesh,
                                                      P("loci", "reads")))
    suffix_lasts = put(jnp.asarray(suffix_lasts),
                       NamedSharding(mesh, P("loci")))
    return _sharded_grouped_stats(mesh, stacked_struct, stacked_meta, seqs,
                                  lengths, suffix_lasts)


def panel_mesh(group_size: int, batch: int, devices=None) -> Mesh | None:
    """Factor the available devices into a (loci, reads) mesh compatible
    with the analyzer's grouped dispatch shapes, or None single-device."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if n <= 1:
        return None
    n_loci = math.gcd(group_size, n)
    n_reads = n // n_loci
    if n_loci * n_reads != n or batch % n_reads != 0:
        return None
    return make_mesh(n_loci=n_loci, n_reads=n_reads, devices=devices)


def data_parallel_read_stats(mesh: Mesh, model_arrays, seqs, lengths):
    """Single-locus variant: reads sharded over every device in the mesh."""
    n = math.prod(mesh.devices.shape)
    flat_mesh = Mesh(mesh.devices.reshape(n), ("reads",))
    B = seqs.shape[0]
    assert B % n == 0, (B, n)
    model_arrays = tuple(
        jax.device_put(m, NamedSharding(flat_mesh, P())) for m in model_arrays)
    seqs = jax.device_put(jnp.asarray(seqs),
                          NamedSharding(flat_mesh, P("reads", None)))
    lengths = jax.device_put(jnp.asarray(lengths),
                             NamedSharding(flat_mesh, P("reads")))
    return da.read_stats(model_arrays, seqs, lengths)
