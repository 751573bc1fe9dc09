"""Device-mesh parallelism for rendering.

Path tracing is embarrassingly parallel in samples, so the scaling recipe
(SURVEY.md §5) is: replicate the scene to every chip, shard the *sample* axis
over the mesh, keep a per-device partial film, and all-reduce the film once
at development time. This replaces the reference's crossbeam thread pool +
CAS film (renderer/mod.rs:120-194, film.rs:145-162) with collectives (NCCL
over NVLink on GPUs) and deterministic per-device accumulation. The mesh is
flat: every card reaches every other at the same rate.

All three algorithms ride the same machinery (the reference runs them all
through one TaskRunner, renderer/mod.rs:77-111): a renderer contributes a
pure per-sample step ``(acc, wt, key, data, row0) -> (acc, wt)`` and the
generic ``run_sharded`` loop shards it over the mesh — including remainder
samples (a trailing step where the surplus devices are masked off) and
checkpoint resume (the resumed film enters device 0's shard).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(devices=None, axis: str = "samples") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def device_film_buffers(film, mesh: Mesh, resume=None):
    """Per-device partial film: [D, H, W, B], sharded along the mesh axis.

    ``resume``: optional (acc [H, W, B], wt) pair restored into device 0's
    shard so the all-reduced total equals the checkpointed film."""
    d = mesh.devices.size
    axis = mesh.axis_names[0]
    sharding = NamedSharding(mesh, P(axis))
    shape = (d, film.height, film.width, film.bins)
    acc_h = np.zeros(shape, np.float32)
    wt_h = np.zeros(shape, np.float32)
    if resume is not None:
        acc_h[0] = np.asarray(resume[0])
        wt_h[0] = np.asarray(resume[1])
    acc = jax.device_put(acc_h, sharding)
    wt = jax.device_put(wt_h, sharding)
    return acc, wt


def sharded_render_step(step_fn, mesh: Mesh):
    """Lift a single-device render step (acc, wt, key, data, row0) ->
    (acc, wt) onto the mesh: each device advances its own film shard with its
    own RNG key; the scene data pytree is replicated. One call renders up to
    D samples (one per device); devices whose ``enabled`` flag is 0 leave
    their shard untouched (how remainder samples are rendered exactly)."""
    axis = mesh.axis_names[0]

    def per_device(acc, wt, keys, enabled, data, row0):
        acc2, wt2 = step_fn(acc[0], wt[0], keys[0], data, row0)
        keep = enabled[0]
        acc2 = jnp.where(keep, acc2, acc[0])
        wt2 = jnp.where(keep, wt2, wt[0])
        return acc2[None], wt2[None]

    mapped = shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(), P()),
        out_specs=(P(axis), P(axis)),
        check_vma=False,
    )
    return jax.jit(mapped, donate_argnums=(0, 1))


def step_keys(key, n_devices: int, step_index: int):
    """Distinct per-device RNG keys for one sharded step."""
    base = jax.random.fold_in(key, step_index)
    return jax.random.split(base, n_devices)


@jax.jit
def merge_films(acc, wt):
    """Reduce per-device film shards [D, H, W, B] -> [H, W, B].

    When the inputs are sharded along D, XLA lowers this to an all-reduce
    across the devices; the result is the replicated full film."""
    return acc.sum(axis=0), wt.sum(axis=0)


def run_sharded(
    step_fn,
    film,
    mesh: Mesh,
    data,
    total: int,
    seed: int = 0,
    chunks: int = 1,
    rows: int = None,
    on_progress=None,
    resume=None,
    progress_cls=None,
):
    """Generic sharded render loop: every requested sample is rendered.

    Samples are taken in groups of D (one per device); a final partial group
    masks off the surplus devices so ``total`` is honored exactly
    (reference bar: renderer/simple.rs:58-78 renders every sample asked).
    ``chunks``/``rows``: row windows per sample (all devices sweep the same
    window concurrently, each with its own stratified sample).
    """
    n_dev = mesh.devices.size
    rows = film.height if rows is None else rows
    start = 0
    resume_films = None
    if resume is not None:
        resume_films = (resume["acc"], resume["wt"])
        start = resume["samples_done"]
    acc, wt = device_film_buffers(film, mesh, resume=resume_films)
    sharded = sharded_render_step(step_fn, mesh)

    key = jax.random.PRNGKey(seed)
    lane = np.arange(n_dev)
    done = start
    # group counter folds into the RNG stream; groups before a checkpoint are
    # always full (size D), so the resumed stream lines up with an
    # uninterrupted run's
    group = -(-start // n_dev)
    while done < total:
        take = min(n_dev, total - done)
        enabled = jnp.asarray(lane < take)
        for c in range(chunks):
            keys = step_keys(key, n_dev, group * chunks + c)
            acc, wt = sharded(acc, wt, keys, enabled, data, c * rows)
        done += take
        group += 1
        if on_progress is not None:
            merged_acc, merged_wt = merge_films(acc, wt)
            on_progress(
                progress_cls(
                    sample=done,
                    total=total,
                    acc=merged_acc,
                    wt=merged_wt,
                    film=film,
                )
            )
    merged_acc, merged_wt = merge_films(acc, wt)
    return film, merged_acc, merged_wt
