"""Device-mesh scaling of the scenario batch.

The reference has no distribution at all (SURVEY §2: single process, ROS
pub/sub); scaling is a new, first-class axis here.  The design follows the
scaling-book recipe: ONE data-parallel mesh axis over scenarios ("dp"), with
sharding annotations on the batch dim and `psum` collectives for the
cross-shard reductions the BASELINE north star names (convergence / KKT
residual checks and benchmark metric aggregation).  Within a shard,
parallelism is vmap; across shards XLA's collectives run over NVLink,
which joins every card of a host to every other at the same rate, so the
mesh follows the algorithm alone: one `dp` axis.

Why only dp?  The per-scenario problem is tiny (nz = 40 condensed vars,
nb <= 20 basis vectors) — sharding inside one MPC solve would put
collectives on microsecond-scale matmuls.  The throughput axis of this
workload is the number of simultaneous closed loops, which shards embarrassingly
and scales linearly as long as the batch is balanced (identical per-lane
iteration counts — guaranteed by the fixed-iteration solvers)."""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None, axis: str = "dp",
              backend: Optional[str] = None) -> Mesh:
    """Mesh over the first n devices of `backend` (the default platform if
    None).  Raises when that platform has fewer than n devices — it never
    falls back to another platform.  CPU runs ask for `backend="cpu"`
    (with --xla_force_host_platform_device_count for virtual devices)."""
    devs = jax.devices(backend) if backend else jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise RuntimeError(
                f"need {n_devices} {devs[0].platform} devices, have {len(devs)}")
        devs = devs[:n_devices]
    import numpy as np

    return Mesh(np.asarray(devs), (axis,))


def shard_episode_batch(mesh: Mesh, tree, axis: str = "dp"):
    """Place a pytree whose leaves have a leading batch dim onto the mesh,
    sharded over that dim."""
    sharding = NamedSharding(mesh, P(axis))

    def put(leaf):
        return jax.device_put(leaf, sharding)

    return jax.tree.map(put, tree)


def psum_metrics(metrics: dict, axis: str = "dp") -> dict:
    """Cross-shard metric reduction (means are computed as psum/psum)."""
    out = {}
    for k, v in metrics.items():
        out[k] = jax.lax.psum(v, axis)
    return out


def sharded_step_fn(mesh: Mesh, step_fn, axis: str = "dp", with_metrics: bool = True):
    """Wrap a batched step `outputs = step_fn(batch_tree)` into a
    shard_map'd version: each device runs its shard of scenarios; global
    scalar metrics are psum-reduced over the mesh.

    step_fn must return (per_scenario_outputs, metrics_dict) where metrics
    are per-shard SUMS (counts, error sums) — they become global sums.
    """
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis),),
        out_specs=(P(axis), P()),
        check_vma=False,
    )
    def stepped(batch_tree):
        outs, metrics = step_fn(batch_tree)
        metrics = {k: jax.lax.psum(v, axis) for k, v in metrics.items()}
        return outs, metrics

    return stepped
