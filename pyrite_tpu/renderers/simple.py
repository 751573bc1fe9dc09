"""The "simple" renderer: camera paths with next-event estimation.

Reference: renderer/simple.rs. The tile/thread machinery is replaced by a
wavefront: every chunk traces one stratified sample for every pixel (the
whole film at once) inside a single jit step with donated film buffers;
chunks iterate until pixel_samples is reached. Sample distribution matches
the reference (uniform jitter per pixel, stratified wavelengths with a
uniformly-chosen hero).
"""

from __future__ import annotations

from dataclasses import dataclass
import os as _os

import jax
import jax.numpy as jnp

from ..film import Film, expose_lanes
from ..scene import CameraModel, Scene
from ..tracer import TraceConfig, trace_paths


def chunk_rays(film: Film, camera: CameraModel, cfg: TraceConfig, key, row0=0, rows=None):
    """One stratified sample per pixel of a row window: positions, primary
    rays, and hero-ordered wavelengths."""
    h, w = film.height, film.width
    rows = h if rows is None else rows
    n = rows * w
    s = cfg.spectrum_samples

    # one PRNG draw for everything: jitter (2) + lens (2) + wavelengths (S)
    # + hero pick (1)
    u = jax.random.uniform(key, (n, s + 5))

    py, px = jnp.meshgrid(row0 + jnp.arange(rows), jnp.arange(w), indexing="ij")
    pxf = px.reshape(-1) + u[:, 0]
    pyf = py.reshape(-1) + u[:, 1]
    positions = film.pixel_to_view(pxf, pyf)

    origin, direction = camera.ray_towards(positions, u[:, 2], u[:, 3])

    wavelengths = film.sample_wavelengths(u[:, 4 : 4 + s])
    # hero selection: swap a uniformly-chosen column into slot 0 — done with
    # masked sums instead of take_along_axis
    hero = jnp.minimum((u[:, 4 + s] * s).astype(jnp.int32), s - 1)
    cols = jnp.arange(s)[None, :]
    is_hero = cols == hero[:, None]
    hero_wl = jnp.sum(jnp.where(is_hero, wavelengths, 0.0), axis=1, keepdims=True)
    first_wl = wavelengths[:, :1]
    wavelengths = jnp.where(
        cols == 0, hero_wl, jnp.where(is_hero, first_wl, wavelengths)
    )

    return positions, origin, direction, wavelengths


def chunk_order(chunks: int):
    """Center-out processing order for row-window chunks, reproducing the
    reference's center-out tile sort (renderer/algorithm.rs:132-150, sorted
    at :185): the subject (image center) resolves first in previews. RNG keys
    stay indexed by chunk id, so results are order-invariant."""
    return sorted(range(chunks), key=lambda c: (abs(c + 0.5 - chunks / 2), c))


def pick_rows(film: Film, scene: Scene, cfg: TraceConfig = None, bounces=None) -> int:
    """Rows per launch, sized so one device launch stays far under the
    execution watchdog: the test budget bounds lanes x prims x bounces x
    (1 + light_samples) per launch. ``bounces`` overrides cfg.bounces (the
    survivor-pool scheduler only traces STAGE_BOUNCES per launch, so its
    chunks can be much larger — launches have a large fixed dispatch cost)."""
    from ..tracer import CLUSTER_LANE_CAP

    budget_lanes = film.height * film.width
    cap = texture_lane_cap(scene)
    if cap is not None:
        budget_lanes = min(budget_lanes, cap)
    if scene.use_clusters:
        budget_lanes = min(budget_lanes, CLUSTER_LANE_CAP)
    elif cfg is not None and scene.num_primitives > 128:
        budget = 6_000_000_000
        depth = bounces if bounces is not None else cfg.bounces
        per_lane = (
            max(scene.num_primitives, 1)
            * max(depth, 1)
            * (1 + cfg.light_samples)
        )
        budget_lanes = min(budget_lanes, max(film.width, budget // per_lane))
    rows = max(1, min(film.height, budget_lanes // film.width))
    while film.height % rows != 0:
        rows -= 1
    return rows


def pick_sample_batch(film: Film, scene: Scene, cfg: TraceConfig, rows: int) -> int:
    """Stratified samples per launch. Only batches when the whole film fits
    one chunk (rows == height) and the scene takes the dense-sweep path; the
    lane total stays under ~600k so per-op cost stays near the overhead
    floor and intermediates stay HBM-safe."""
    import os

    from ..tracer import CLUSTER_LANE_CAP

    cap = int(os.environ.get("PYRITE_TPU_SAMPLE_BATCH", "4"))
    if rows != film.height or cap <= 1:
        return 1
    lanes = rows * film.width
    if scene.use_clusters:
        # widen cluster launches only when the (env-tunable) walk width
        # allows more than one sample's lanes
        return max(1, min(cap, CLUSTER_LANE_CAP // max(lanes, 1)))
    if cfg is not None and scene.num_primitives > 128:
        # respect the same per-launch work budget as pick_rows
        budget = 6_000_000_000
        per_lane = (
            max(scene.num_primitives, 1)
            * max(cfg.bounces, 1)
            * (1 + cfg.light_samples)
        )
        cap = min(cap, max(1, budget // max(per_lane * lanes, 1)))
    return max(1, min(cap, 600_000 // max(lanes, 1)))


def make_render_step(scene: Scene, film: Film, camera: CameraModel, cfg: TraceConfig, rows=None, jit=True, samples=1):
    """Build the jitted accumulation step covering ``samples`` stratified
    samples per pixel per launch.

    The bounce loop is iteration-bound on this backend (per-op overhead is
    ~15 us regardless of width below ~10^5 lanes), so tracing several
    samples' lanes in ONE wavefront raises live-ray throughput nearly
    linearly with ``samples`` — the reference gets the same effect for free
    from its per-thread loop (renderer/mod.rs:126).

    The step takes the scene's device data as an argument (scene.device_data())
    so geometry and texture arrays are jit inputs, not compiled constants.
    ``jit=False`` returns the traced function un-jitted (for wrapping in a
    shard_map, which jits at the outer level). With samples == 1 the ``key``
    argument is a single PRNG key; with samples > 1 it is a [samples] key
    array (one per sub-sample, so ray generation matches sequential runs)."""
    rows = film.height if rows is None else rows

    def step(acc, wt, key, data, row0=0):
        with scene.bind(data):
            keys = key if samples > 1 else key[None]
            parts = [
                chunk_rays(film, camera, cfg, keys[s], row0=row0, rows=rows)
                for s in range(samples)
            ]
            cat = lambda i: jnp.concatenate([p[i] for p in parts], axis=0)
            origin, direction, wavelengths = cat(1), cat(2), cat(3)
            k_trace = jax.random.fold_in(keys[0], 7)
            brightness, aux_alive = trace_paths(
                scene, cfg, k_trace, origin, direction, wavelengths
            )
            n, s_count = brightness.shape
            mask = jnp.concatenate(
                [
                    jnp.ones((n, 1), bool),
                    jnp.broadcast_to(aux_alive[:, None], (n, s_count - 1)),
                ],
                axis=1,
            )
            weights = jnp.ones_like(brightness)
            per = n // samples
            for s in range(samples):
                sl = slice(s * per, (s + 1) * per)
                acc, wt = expose_lanes(
                    film, acc, wt, row0, wavelengths[sl], brightness[sl],
                    weights[sl], mask[sl],
                )
            return acc, wt

    return jax.jit(step, donate_argnums=(0, 1)) if jit else step


# =============================================================================
# Path-regeneration scheduler (dense scenes, any bounce depth)
# =============================================================================
#
# The flat wavefront wastes the 4x live-vs-executed gap on shallow scenes
# (spheres survival after bounces 1-8: 60/16/5.8/3.5/2.4/1.9/1.6/1.4%, so
# mean occupancy is ~24%) and the survivor pool only recovers deep-bounce
# scenes. Per-lane shuffles at megabatch width cost more than the masked
# work they save (on the first backend; not measured on the H100), so
# compaction cannot fix it. Path REGENERATION can:
# every lane owns a fixed film pixel; the moment its path dies, the lane
# exposes the finished sample into a per-lane bin accumulator (vector math,
# no scatter) and immediately restarts a fresh stratified sample at the
# same pixel. Occupancy stays ~100% for the whole launch minus the final
# paths' tail, with zero cross-lane data movement. This matches the
# reference's per-thread sample loop (renderer/simple.rs:23-73 runs
# `for _ in 0..samples { trace }` per tile) more directly than the
# chunk-per-sample wavefront did — a thread there also starts the next
# sample the moment one finishes.
#
# Estimator parity with the one-shot path: each (pixel, sample) is an
# independent stratified draw with the same jitter/lens/wavelength scheme
# (chunk_rays), the same per-bounce PRNG structure, the same exposure
# weights (1 per completed sample on the hero column, aux columns masked by
# the dispersal flag). One documented deviation: the key derivation differs
# (draws depend on loop iteration, not sample index). Sample counts are
# EXACT per pixel, but the lanes trace past their quota: a launch runs
# until its slowest lane completes the per-launch quota, and every dead
# lane restarts unconditionally in the meantime ("overshoot" — without it,
# tail idling capped occupancy at ~23% on the spheres scene, and a
# done->regen data edge slowed each iteration on the first backend).
# Quota is enforced at EXPOSURE instead: a completed
# sample is included iff the lane's completion count is still below quota.
# Within a lane samples complete in start order, so inclusion is exactly
# "the first Q samples" — a deterministic selection, hence unbiased.
# (Including the extras instead is biased: the realized per-pixel weight
# then correlates with path lengths through the stopping rule — measured
# +7.5% radiance on the deep-bounce parity test; truncating in-flight
# extras mid-path was worse still, +69% on the terrain parity test.)
# Overshoot tracing costs no wall time: the loop iteration count is set by
# the slowest lane either way, so extras ride otherwise-idle lanes.

# Megabatch width of the regen wavefront: amortizes per-launch cost. Not yet
# swept on the H100.
REGEN_TARGET_LANES = int(
    _os.environ.get("PYRITE_TPU_REGEN_LANES", "524288")
)
REGEN_MAX_PLANES = 8


def regen_enabled() -> bool:
    import os

    return os.environ.get("PYRITE_TPU_REGEN", "1") == "1"


def regen_clusters_enabled() -> bool:
    """Regen for cluster (wide-BVH) scenes: the traversal is bound by
    per-walk-iteration launches, so regen's occupancy win shrinks the number
    of bounce iterations per sample (bounces / E[path length]) rather than
    the per-iteration cost. Default ON (it beat the one-shot walk on the
    328k-tri terrain on the first backend; not measured on the H100)."""
    import os

    return os.environ.get("PYRITE_TPU_REGEN_CLUSTERS", "1") == "1"


def _accumulate_lane_bins(film: Film, acc_l, wt_l, wavelengths, brightness, aux_alive, complete):
    """Per-lane spectral-bin accumulation for completed paths: the same
    one-hot wavelength->bin contraction as expose_lanes, but into [N, bins]
    per-lane buffers (lanes own fixed pixels, so no cross-lane scatter)."""
    from ..film import bin_lane_sums

    n, s = brightness.shape
    mask = complete[:, None] & jnp.concatenate(
        [jnp.ones((n, 1), bool), jnp.broadcast_to(aux_alive[:, None], (n, s - 1))],
        axis=1,
    )
    v = jnp.where(mask, brightness, 0.0)
    w = jnp.where(mask, 1.0, 0.0)
    da, dw = bin_lane_sums(film, wavelengths, v, w)
    return acc_l + da, wt_l + dw


def make_regen_step(scene: Scene, film: Film, camera: CameraModel, cfg: TraceConfig, rows=None, planes=1, jit=True):
    """Build the jitted path-regeneration launch.

    The step exposes AT MOST ``spp_lane[l]`` full paths on every lane l
    (``planes`` lanes per pixel, so a pixel gains sum-over-its-planes
    samples per launch), with dead lanes regenerated in place each bounce.
    Lanes restart unconditionally while the launch runs (occupancy ~100%);
    quota is enforced at exposure (first-Q inclusion, see the module
    comment), so extras trace but never expose. The launch exits once at
    most ``tail_count`` lanes are still short of quota — the host carries
    their remainders into the next launch's quotas (exactness preserved:
    callers subtract REALIZED completions, min(done, quota), from the
    per-lane remainders), so the slowest ~1% of lanes never serialize the
    other 99%. ``spp_lane`` and ``tail_count`` are device arguments,
    so launches of any sample count share one compile.
    Returns (acc, wt, live_bounces, executed_bounces, done) — the counters
    feed bench.py's live-lane accounting; ``done`` [n] counts ALL
    completions (including discarded extras), an unbiased per-lane
    completion-rate signal the host uses for adaptive quota balancing."""
    from ..tracer import bounce_core

    rows = film.height if rows is None else rows
    w = film.width
    pix = rows * w
    n = pix * planes
    s = cfg.spectrum_samples

    def fresh_rays(key, row0):
        u = jax.random.uniform(key, (n, s + 5))
        py, px = jnp.meshgrid(row0 + jnp.arange(rows), jnp.arange(w), indexing="ij")
        pxf = jnp.tile(px.reshape(-1), planes) + u[:, 0]
        pyf = jnp.tile(py.reshape(-1), planes) + u[:, 1]
        positions = film.pixel_to_view(pxf, pyf)
        origin, direction = camera.ray_towards(positions, u[:, 2], u[:, 3])
        wavelengths = film.sample_wavelengths(u[:, 4 : 4 + s])
        hero = jnp.minimum((u[:, 4 + s] * s).astype(jnp.int32), s - 1)
        cols = jnp.arange(s)[None, :]
        is_hero = cols == hero[:, None]
        hero_wl = jnp.sum(jnp.where(is_hero, wavelengths, 0.0), axis=1, keepdims=True)
        first_wl = wavelengths[:, :1]
        wavelengths = jnp.where(
            cols == 0, hero_wl, jnp.where(is_hero, first_wl, wavelengths)
        )
        return origin, direction, wavelengths

    from .. import tracer as tracer_mod

    deferred = scene.use_clusters and tracer_mod.merged_traversal_enabled()

    def step(acc, wt, key, data, row0, spp_lane, tail_count=0):
        with scene.bind(data):
            k_gen = jax.random.fold_in(key, 7919)
            k_tr = jax.random.fold_in(key, 7)
            state = _trace_state(jnp.zeros((n, 3)), jnp.zeros((n, 3)).at[:, 2].set(1.0), s)
            state["alive"] = jnp.zeros(n, bool)
            carry = {
                "i": jnp.int32(0),
                "state": state,
                "wl": jnp.full((n, s), film.span[0]),
                "acc_l": jnp.zeros((n, film.bins)),
                "wt_l": jnp.zeros((n, film.bins)),
                "done": jnp.zeros(n, jnp.int32),
                "pend": jnp.zeros(n, bool),
                "plen": jnp.zeros(n, jnp.int32),
                "live": jnp.float32(0.0),
                # short-lane count carried in the loop state: the cond reads
                # it instead of recomputing sum(done < spp) — a THIRD
                # comparison against yet another done tensor, the same
                # fusion-cliff class the body just paid to remove
                "short": jnp.sum((0 < spp_lane).astype(jnp.int32)),
            }
            max_iters = (jnp.max(spp_lane) + 1) * cfg.bounces

            def cond(c):
                return (c["short"] > tail_count) & (c["i"] < max_iters)

            def body(c):
                st = c["state"]
                # 1) expose paths that completed last bounce — but only the
                # lane's first Q samples (done counts ALL completions; a
                # completion is included iff the count was still short).
                # Quota lives HERE and not on the regen mask: gating
                # exposure keeps counts exact without a done->regen data
                # edge in the loop.
                complete = c["pend"] & ~st["alive"]
                done = c["done"] + complete.astype(jnp.int32)
                # ONE post-update comparison tensor serves both the exposure
                # gate and the live counter below (comparing against two
                # different done tensors fused worse on the first backend). On
                # complete lanes done = c.done+1, so (done <= Q) there is
                # exactly the old (c.done < Q): inclusion is unchanged
                # first-Q, still exact and unbiased.
                include = complete & (done <= spp_lane)
                acc_l, wt_l = _accumulate_lane_bins(
                    film, c["acc_l"], c["wt_l"], c["wl"], st["brightness"],
                    st["aux_alive"], include,
                )
                pend = c["pend"] & st["alive"]
                # 2) regenerate: fresh stratified sample at the lane's
                # pixel. EVERY dead lane restarts, even past its quota
                # ("overshoot"): the launch runs until the slowest lane
                # fills its quota either way, so quota-done lanes trace
                # discarded extras instead of idling (the tail is the
                # loss without overshoot).
                reg = ~st["alive"]
                o2, d2, wl2 = fresh_rays(
                    jax.random.fold_in(k_gen, c["i"]), row0
                )
                rc = reg[:, None]
                st = {
                    "origin": jnp.where(rc, o2, st["origin"]),
                    "direction": jnp.where(rc, d2, st["direction"]),
                    "brightness": jnp.where(rc, 0.0, st["brightness"]),
                    "reflectance": jnp.where(rc, 1.0, st["reflectance"]),
                    "alive": st["alive"] | reg,
                    "aux_alive": jnp.where(reg, True, st["aux_alive"]),
                    "sample_light": jnp.where(reg, True, st["sample_light"]),
                    "light_events": jnp.where(reg, 0, st["light_events"]),
                }
                wl = jnp.where(rc, wl2, c["wl"])
                pend = pend | reg
                plen = jnp.where(reg, 0, c["plen"])
                # live counts only quota-bound lanes (a lane's in-flight
                # sample index is done+1, so done < Q iff it will expose) —
                # discarded extras are not useful throughput. Post-regen
                # alive is vacuously all-true (every dead lane restarted),
                # so the & edge is dropped: same counts, and the comparison
                # reuses the shared post-update done tensor (see above);
                # its reduction also feeds the carried short-lane count the
                # cond reads (post-body done is exactly what the old cond
                # recomputed from the carry).
                quota = (done < spp_lane).astype(jnp.int32)
                short = jnp.sum(quota)
                live = c["live"] + short.astype(jnp.float32)
                # 3) one bounce for every live lane
                st, _ = bounce_core(
                    scene, cfg, wl, st, jax.random.fold_in(k_tr, c["i"])
                )
                # 4) per-path depth budget (the one-shot loop's iteration
                # count becomes a per-lane counter here)
                plen = plen + st["alive"].astype(jnp.int32)
                st["alive"] = st["alive"] & (plen < cfg.bounces)
                return {
                    "i": c["i"] + 1, "state": st, "wl": wl, "acc_l": acc_l,
                    "wt_l": wt_l, "done": done, "pend": pend, "plen": plen,
                    "live": live, "short": short,
                }

            def body_deferred(c):
                """Deferred cluster bounce (tracer.merged_traversal_enabled):
                shade against the carried hit, regenerate dead lanes, then
                ONE merged traversal covers the bounce's NEE shadow batch and
                every next ray (scattered + freshly regenerated) — one walk's
                per-iteration dispatch per bounce instead of two serial
                walks'. Exposure runs in-body (after the NEE delta lands) so
                budget-killed lanes keep their final bounce's NEE. Quota is
                enforced at exposure exactly as in body()."""
                st = c["state"]
                live = c["live"] + jnp.sum(
                    (st["alive"] & (c["done"] < spp_lane)).astype(jnp.float32)
                )
                new_st, _, nee = bounce_core(
                    scene, cfg, c["wl"], st, jax.random.fold_in(k_tr, c["i"]),
                    hit=c["hit"], defer_nee=True,
                )
                plen = c["plen"] + new_st["alive"].astype(jnp.int32)
                alive = new_st["alive"] & (plen < cfg.bounces)
                complete = c["pend"] & ~alive
                include = complete & (c["done"] < spp_lane)
                done = c["done"] + complete.astype(jnp.int32)
                reg = ~alive  # unconditional overshoot restart: see body()
                o2, d2, wl2 = fresh_rays(
                    jax.random.fold_in(k_gen, c["i"] + 1), row0
                )
                rc = reg[:, None]
                next_o = jnp.where(rc, o2, new_st["origin"])
                next_d = jnp.where(rc, d2, new_st["direction"])
                next_hit, delta = tracer_mod.merged_shadow_extension(
                    scene, cfg, nee, next_o, next_d, alive | reg, s
                )
                brightness = new_st["brightness"]
                if delta is not None:
                    brightness = brightness + delta
                acc_l, wt_l = _accumulate_lane_bins(
                    film, c["acc_l"], c["wt_l"], c["wl"], brightness,
                    new_st["aux_alive"], include,
                )
                wl = jnp.where(rc, wl2, c["wl"])
                state2 = {
                    "origin": next_o,
                    "direction": next_d,
                    "brightness": jnp.where(rc, 0.0, brightness),
                    "reflectance": jnp.where(rc, 1.0, new_st["reflectance"]),
                    "alive": alive | reg,
                    "aux_alive": jnp.where(reg, True, new_st["aux_alive"]),
                    "sample_light": jnp.where(reg, True, new_st["sample_light"]),
                    "light_events": jnp.where(reg, 0, new_st["light_events"]),
                }
                return {
                    "i": c["i"] + 1, "state": state2, "hit": next_hit,
                    "wl": wl, "acc_l": acc_l, "wt_l": wt_l, "done": done,
                    "pend": (c["pend"] & alive) | reg,
                    "plen": jnp.where(reg, 0, plen), "live": live,
                    # carried short-lane count for the cond (see body())
                    "short": jnp.sum((done < spp_lane).astype(jnp.int32)),
                }

            if deferred:
                # pre-loop regeneration of every lane with work, so the first
                # shade has a hit to consume (in-loop regen rides the merged
                # traversal thereafter)
                has = spp_lane > 0
                o0, d0, wl0 = fresh_rays(jax.random.fold_in(k_gen, 0), row0)
                st0 = _trace_state(o0, d0, s)
                st0["alive"] = has
                carry["state"] = st0
                carry["wl"] = wl0
                carry["pend"] = has
                carry["hit"] = tracer_mod.intersect_scene(scene, o0, d0, cfg)
                c = jax.lax.while_loop(cond, body_deferred, carry)
            else:
                c = jax.lax.while_loop(cond, body, carry)
            # final-iteration deaths were never exposed in-loop; in-flight
            # paths at exit are all past-quota extras (discarded by ~alive
            # here and by the quota mask if dead)
            st = c["state"]
            complete_f = c["pend"] & ~st["alive"]
            include = complete_f & (c["done"] < spp_lane)
            acc_l, wt_l = _accumulate_lane_bins(
                film, c["acc_l"], c["wt_l"], c["wl"], st["brightness"],
                st["aux_alive"], include,
            )
            # fold sample planes and write the row window
            acc_delta = acc_l.reshape(planes, pix, film.bins).sum(axis=0)
            wt_delta = wt_l.reshape(planes, pix, film.bins).sum(axis=0)
            flat_acc = acc.reshape(film.height * film.width, film.bins)
            flat_wt = wt.reshape(film.height * film.width, film.bins)
            start = row0 * w
            flat_acc = jax.lax.dynamic_update_slice_in_dim(
                flat_acc,
                jax.lax.dynamic_slice_in_dim(flat_acc, start, pix) + acc_delta,
                start, axis=0,
            )
            flat_wt = jax.lax.dynamic_update_slice_in_dim(
                flat_wt,
                jax.lax.dynamic_slice_in_dim(flat_wt, start, pix) + wt_delta,
                start, axis=0,
            )
            executed = c["i"].astype(jnp.float32) * n
            # the returned completion counts MUST include the post-loop
            # exposure's completions: the host subtracts min(done, quota)
            # from its remainders, and under the soft-tail exit a lane short
            # of quota can complete (and expose) on the final iteration —
            # omitting it here double-counts that sample next launch
            done_out = c["done"] + complete_f.astype(jnp.int32)
            return (
                flat_acc.reshape(acc.shape), flat_wt.reshape(wt.shape),
                c["live"], executed, done_out,
            )

    return jax.jit(step, donate_argnums=(0, 1)) if jit else step


def texture_lane_cap(scene) -> int | None:
    """Regen wavefront bound for texture-program scenes, else None.

    The regen accumulators plus the per-bounce 16-tap bicubic color and
    normal-map temporaries grow with the wavefront; 131k lanes keeps the
    concurrent gather temporaries bounded. The cap is not yet swept on the
    H100."""
    has_tex = any(p.uses_texture for p in scene.color_programs) or any(
        getattr(p, "uses_texture", False) for p in scene.normal_programs
    )
    return 131072 if has_tex else None


def _regen_planes(film: Film, rows: int, use_clusters: bool = False, scene=None) -> int:
    from ..tracer import CLUSTER_LANE_CAP

    # cluster scenes keep the tuned walk width (CLAUDE.md; env-overridable)
    target = CLUSTER_LANE_CAP if use_clusters else REGEN_TARGET_LANES
    if scene is not None:
        cap = texture_lane_cap(scene)
        if cap is not None:
            target = min(target, cap)
    pix = rows * film.width
    return max(1, min(REGEN_MAX_PLANES, target // max(pix, 1)))


def adaptive_quotas(rem, rate, spp_target):
    """Per-launch lane quotas balanced by measured completion rates.

    A launch runs until its SLOWEST lane completes its quota, and a lane's
    mean path depth is a property of its fixed pixel (glass pixels bounce
    ~6x deeper than sky pixels on the spheres scene), so UNIFORM quotas
    leave shallow lanes tracing discarded extras for ~4x their own quota's
    time — the measured live/executed occupancy ceiling was ~23%. Giving
    every lane quota ~ rate x T makes all lanes finish near the same
    iteration T. This is the wavefront analogue of the reference's
    demand-driven task dispatch (renderer/mod.rs:126-189: an idle worker
    pulls the next tile; here a shallow lane pulls more samples per
    launch). Exactness is preserved: quotas are clipped to the per-lane
    remaining counts and the host iterates until all remainders are zero.

    ``rate`` completions/lane/iteration (None before the first launch ->
    uniform quotas); ``spp_target`` samples the MEAN lane should complete."""
    import numpy as np

    if rate is None:
        return np.minimum(rem, spp_target).astype(np.int32)
    t = spp_target / max(float(rate.mean()), 1e-6)
    q = np.rint(rate * t).astype(np.int32)
    # a lane with work always gets at least 1 (its sample is the launch's
    # critical path whenever 1/rate > t; postponing it only moves the cost)
    return np.minimum(rem, np.maximum(q, 1)).astype(np.int32)


def _render_regen(
    scene, film, camera, cfg, rows, acc, wt, data, seed,
    start_sample, total, on_progress, spp_chunk=None,
):
    """Host driver for the regeneration scheduler: rounds of launches per
    row window until the exact requested sample count is reached. Quotas
    within a launch are balanced per lane by measured completion rates
    (adaptive_quotas), and each launch exits once <=1% of lanes are short
    of quota (soft tail — the remainders carry into the next round's
    quotas, so the slowest lanes never serialize the rest); remainders
    split across planes, so sample counts match the sequential renderer
    exactly."""
    import numpy as np

    planes = _regen_planes(film, rows, scene.use_clusters, scene=scene)
    chunks = film.height // rows
    step = make_regen_step(scene, film, camera, cfg, rows=rows, planes=planes)
    if spp_chunk is None:
        # per-LANE quota target per launch. Bigger launches amortize what
        # the soft tail doesn't cover; 160 keeps launches short enough that
        # previews/checkpoints land between them (the reference spheres
        # workload is 150 samples/lane anyway, one full launch). Cluster
        # scenes (the walk, not the tail, is their bound) and deep-bounce
        # scenes keep shorter launches. Not yet swept on the H100.
        spp_chunk = 64 if (scene.use_clusters or cfg.bounces >= POOL_MIN_BOUNCES) else 160
    base_key = jax.random.PRNGKey(seed)
    order = chunk_order(chunks)
    pix = rows * film.width
    n = pix * planes
    # per-lane remaining counts: planes split the per-pixel request
    base, r = divmod(total - start_sample, planes)
    v = np.full(planes, base, np.int32)
    v[:r] += 1
    rem = np.broadcast_to(np.repeat(v, pix), (chunks, n)).copy()
    rate = [None] * chunks
    rnd = 0
    # ramp the per-launch quota up to spp_chunk: the first small rounds
    # warm the per-lane completion rates AND land a preview within seconds
    # (a full-size first launch would delay the first progress callback by
    # the whole chunk)
    cur_chunk = max(4, spp_chunk // 8)
    while rem.any():
        for ci in order:
            if not rem[ci].any():
                continue
            quota = adaptive_quotas(rem[ci], rate[ci], cur_chunk)
            # soft tail: the launch may leave up to 1% of lanes short, but
            # must complete at least one quota-bound lane so the host loop
            # always progresses
            active = int((quota > 0).sum())
            tail = min(n // 100, active - 1) if active > 1 else 0
            # fold the resume offset too: a resumed render must not replay
            # the fresh render's key sequence (same keys + same scene =
            # duplicated sample streams)
            key = jax.random.fold_in(
                jax.random.fold_in(base_key, ci), rnd + start_sample
            )
            acc, wt, _, ex, dn = step(
                acc, wt, key, data, ci * rows, jnp.asarray(quota),
                jnp.int32(tail),
            )
            dn_h = np.asarray(dn)
            rem[ci] -= np.minimum(dn_h, quota)
            # completion rate (incl. discarded extras — they complete at the
            # lane's own pace, so they are an unbiased rate signal); the
            # iteration count is RNG-deterministic, so quotas (and the whole
            # render) stay reproducible for a given seed
            iters = max(float(ex) / n, 1.0)
            fresh = np.maximum(dn_h.astype(np.float32), 0.25) / iters
            rate[ci] = fresh if rate[ci] is None else 0.5 * (rate[ci] + fresh)
        rnd += 1
        cur_chunk = min(spp_chunk, cur_chunk * 2)
        if on_progress is not None:
            done_min = total - int(
                np.max(rem.reshape(chunks, planes, pix).sum(axis=1))
            )
            on_progress(RenderProgress(
                sample=done_min, total=total, acc=acc, wt=wt, film=film,
            ))
    return film, acc, wt


# =============================================================================
# Survivor-pool scheduler (deep-bounce scenes)
# =============================================================================
#
# For deep path budgets (diamonds/snowflake run 256 bounces) the flat
# wavefront is almost empty almost immediately: on the diamonds scene only
# 4% of lanes survive bounce 2 and the mean occupancy over the full budget
# is 0.7%, so a fixed-depth step executes ~140x more masked lane-bounces
# than useful ones. This is the device-resident ray-pool replacement for
# the reference's per-thread loop (renderer/mod.rs:126-189 runs each path
# exactly as deep as it needs): each chunk traces a short stage; lanes that
# die are exposed immediately; survivors are stream-compacted into a
# persistent pool (carrying film position, wavelengths and accumulated
# state) that continues tracing — across chunks and pixel samples — only
# when full, with whole-pool early exit. Every lane is exposed exactly
# once, so the estimator matches the one-shot path sample-for-sample.

POOL_MIN_BOUNCES = 16  # below this, the flat wavefront is fine
STAGE_BOUNCES = 8  # bounces traced before survivors are pooled
CONT_BOUNCES = 32  # bounces per pool-continuation launch
POOL_FACTOR = 8  # pool capacity as a multiple of the stage chunk size


def _trace_state(origin, direction, s_count):
    n = origin.shape[0]
    return {
        "origin": origin,
        "direction": direction,
        "brightness": jnp.zeros((n, s_count)),
        "reflectance": jnp.ones((n, s_count)),
        "alive": jnp.ones(n, bool),
        "aux_alive": jnp.ones(n, bool),
        "sample_light": jnp.ones(n, bool),
        "light_events": jnp.zeros(n, jnp.int32),
    }


def _run_bounces(scene, cfg, wavelengths, state, key, max_steps):
    """Up to max_steps bounces with whole-batch early exit."""
    from ..tracer import bounce_core

    def cond(carry):
        i, st = carry
        return (i < max_steps) & jnp.any(st["alive"])

    def body(carry):
        i, st = carry
        new, _ = bounce_core(scene, cfg, wavelengths, st, jax.random.fold_in(key, i))
        return i + 1, new

    _, state = jax.lax.while_loop(cond, body, (jnp.int32(0), state))
    return state


def make_pooled_steps(scene: Scene, film: Film, camera: CameraModel, cfg: TraceConfig, rows, jit=True):
    """The jitted pieces of the survivor-pool scheduler: stage (trace +
    expose dead + pool survivors), flush-step and shrink factories (the
    width ladder), expose-pool, plus the empty pool constructor.
    ``jit=False`` returns the raw traced functions (for shard_map lifting,
    which jits at the outer level)."""
    n = rows * film.width
    s = cfg.spectrum_samples

    def full_mask(state):
        return jnp.concatenate(
            [
                jnp.ones((state["alive"].shape[0], 1), bool),
                jnp.broadcast_to(
                    state["aux_alive"][:, None],
                    (state["alive"].shape[0], s - 1),
                ),
            ],
            axis=1,
        )

    def stage(acc, wt, pool, fill, key, data, row0=0):
        """New chunk: trace STAGE_BOUNCES, expose lanes that completed, and
        stream-compact survivors into the pool at offset ``fill`` — one
        launch for the whole pipeline stage (launches carry a large fixed
        dispatch cost on this backend)."""
        with scene.bind(data):
            positions, origin, direction, wavelengths = chunk_rays(
                film, camera, cfg, key, row0=row0, rows=rows
            )
            state = _trace_state(origin, direction, s)
            state = _run_bounces(
                scene, cfg, wavelengths, state,
                jax.random.fold_in(key, 7), STAGE_BOUNCES,
            )
            mask = full_mask(state) & ~state["alive"][:, None]
            acc, wt = expose_lanes(
                film, acc, wt, row0, wavelengths, state["brightness"],
                jnp.ones((n, s)), mask,
            )
            alive = state["alive"]
            pos = jnp.cumsum(alive) - 1 + fill
            idx = jnp.where(alive, pos, pool_n)  # dead lanes dropped

            def put(dst, src):
                return dst.at[idx].set(src, mode="drop")

            pool = {
                "state": jax.tree_util.tree_map(put, pool["state"], state),
                "positions": put(pool["positions"], positions),
                "wavelengths": put(pool["wavelengths"], wavelengths),
                "valid": pool["valid"].at[idx].set(True, mode="drop"),
            }
            n_alive = jnp.sum(alive.astype(jnp.int32))
            return acc, wt, pool, n_alive

    # Pool capacity is POOL_FACTOR x the chunk size: the host flushes
    # whenever the remaining space could not absorb a worst-case
    # (all-survive) chunk, so the in-stage scatter can never drop a
    # survivor. The pool is deliberately large: the bounce loop was
    # ITERATION-bound on the first backend (an iteration cost about the same
    # at any width below ~50k lanes), and a flush pays the full
    # bounce-tail depth in iterations however few lanes it holds — so
    # flushes must be rare, amortized over many pixel samples.
    pool_n = POOL_FACTOR * n

    def empty_pool():
        state = _trace_state(jnp.zeros((pool_n, 3)), jnp.ones((pool_n, 3)), s)
        state["alive"] = jnp.zeros(pool_n, bool)
        return {
            "state": state,
            "positions": jnp.zeros((pool_n, 2)),
            "wavelengths": jnp.full((pool_n, s), film.span[0]),
            "valid": jnp.zeros(pool_n, bool),
        }

    def make_flush_step(steps):
        """Continue a pool ``steps`` bounces; returns (pool, alive count).
        All pool entries always share the same remaining bounce budget
        (every stage runs exactly STAGE_BOUNCES), so the host caps the total
        continuation depth at exactly cfg.bounces - STAGE_BOUNCES by sizing
        the launches — no per-lane depth counters needed. Width-polymorphic:
        jit specializes per pool size (the flush ladder shrinks the pool as
        survivors die off, so the deep tail runs at a narrow width)."""

        def flush_step(pool, key, data):
            with scene.bind(data):
                state = _run_bounces(
                    scene, cfg, pool["wavelengths"], pool["state"], key, steps
                )
                return (
                    {**pool, "state": state},
                    jnp.sum(state["alive"].astype(jnp.int32)),
                )

        return jax.jit(flush_step, donate_argnums=(0,)) if jit else flush_step

    def make_shrink(width_to):
        """Expose a pool's finished lanes and compact the live ones into a
        ``width_to``-wide pool (the host only calls this when the live count
        fits). One rung of the flush ladder."""

        def shrink(acc, wt, pool, data):
            with scene.bind(data):
                state = pool["state"]
                w = state["alive"].shape[0]
                done = pool["valid"] & ~state["alive"]
                mask = full_mask(state) & done[:, None]
                acc, wt = film.expose(
                    acc, wt, pool["positions"], pool["wavelengths"],
                    state["brightness"], jnp.ones((w, s)), mask,
                )
                live = pool["valid"] & state["alive"]
                pos = jnp.cumsum(live) - 1
                idx = jnp.where(live, pos, width_to)

                def put(src, fill_value):
                    empty = jnp.full(
                        (width_to,) + src.shape[1:], fill_value, src.dtype
                    )
                    return empty.at[idx].set(src, mode="drop")

                small = {
                    "state": jax.tree_util.tree_map(
                        lambda x: put(x, 0), pool["state"]
                    ),
                    "positions": put(pool["positions"], 0),
                    "wavelengths": put(pool["wavelengths"], film.span[0]),
                    "valid": put(pool["valid"], False),
                }
                # compacted lanes are live by construction
                small["state"]["alive"] = small["valid"]
                return acc, wt, small

        return jax.jit(shrink, donate_argnums=(0, 1, 2)) if jit else shrink

    def expose_pool(acc, wt, pool):
        state = pool["state"]
        w = state["alive"].shape[0]
        mask = full_mask(state) & pool["valid"][:, None]
        return film.expose(
            acc, wt, pool["positions"], pool["wavelengths"],
            state["brightness"], jnp.ones((w, s)), mask,
        )

    if not jit:
        return stage, empty_pool, make_flush_step, make_shrink, expose_pool, expose_pool
    return (
        jax.jit(stage, donate_argnums=(0, 1, 2)),
        empty_pool,
        make_flush_step,
        make_shrink,
        jax.jit(expose_pool, donate_argnums=(0, 1)),
        # non-donating copy for previews: includes in-flight survivors'
        # partial brightness so progress callbacks see pooled contributions
        # between flushes (otherwise previews jump at flush boundaries)
        jax.jit(expose_pool),
    )


@dataclass
class RenderProgress:
    sample: int
    total: int
    acc: object
    wt: object
    film: object


def render(project_data, scene: Scene, seed: int = 0, on_progress=None, max_samples=None, resume=None):
    """Render the project with the simple algorithm; returns (film, acc, wt)."""
    project = project_data.project
    settings = project.renderer
    film = Film(
        width=project.image.width,
        height=project.image.height,
        bins=settings.spectrum_bins,
        span=settings.spectrum_span,
    )
    camera = CameraModel.from_ir(project.camera)
    cfg = TraceConfig(
        bounces=settings.bounces,
        light_samples=settings.light_samples,
        spectrum_samples=settings.spectrum_samples,
    )
    rows = pick_rows(film, scene, cfg)

    acc, wt = film.new_buffers()
    start_sample = 0
    if resume is not None:
        import jax.numpy as _jnp

        acc = _jnp.asarray(resume["acc"])
        wt = _jnp.asarray(resume["wt"])
        start_sample = resume["samples_done"]
    data = scene.device_data()
    total = settings.pixel_samples if max_samples is None else min(
        settings.pixel_samples, max_samples
    )
    chunks = film.height // rows
    # all step keys in one device op: per-step fold_in would pay the host
    # dispatch round-trip between every step
    import numpy as np

    keys = np.asarray(jax.random.split(jax.random.PRNGKey(seed), total * chunks))

    if regen_enabled() and (not scene.use_clusters or regen_clusters_enabled()):
        return _render_regen(
            scene, film, camera, cfg, rows, acc, wt, data, seed,
            start_sample, total, on_progress,
        )

    if cfg.bounces >= POOL_MIN_BOUNCES:
        pooled_rows = pick_rows(film, scene, cfg, bounces=STAGE_BOUNCES)
        if pooled_rows != rows:
            # the pooled scheduler only traces STAGE_BOUNCES per launch, so
            # its chunks can be much larger than the one-shot budget allows
            rows = pooled_rows
            chunks = film.height // rows
            keys = np.asarray(
                jax.random.split(jax.random.PRNGKey(seed), total * chunks)
            )
        return _render_pooled(
            scene, film, camera, cfg, rows, acc, wt, data, keys,
            start_sample, total, chunks, on_progress, seed=seed,
        )

    batch = pick_sample_batch(film, scene, cfg, rows)
    if batch > 1 and chunks == 1:
        step = make_render_step(scene, film, camera, cfg, rows=rows, samples=batch)
        tail_step = None
        i = start_sample
        while i < total:
            take = min(batch, total - i)
            if take == batch:
                kgroup = jnp.stack([jnp.asarray(keys[i + s]) for s in range(take)])
                acc, wt = step(acc, wt, kgroup, data, 0)
            else:
                if tail_step is None:
                    tail_step = make_render_step(scene, film, camera, cfg, rows=rows)
                for s in range(take):
                    acc, wt = tail_step(acc, wt, keys[i + s], data, 0)
            i += take
            if on_progress is not None:
                on_progress(RenderProgress(sample=i, total=total, acc=acc, wt=wt, film=film))
        return film, acc, wt

    step = make_render_step(scene, film, camera, cfg, rows=rows)
    order = chunk_order(chunks)
    for i in range(start_sample, total):
        for c in order:
            acc, wt = step(acc, wt, keys[i * chunks + c], data, c * rows)
        if on_progress is not None:
            on_progress(RenderProgress(sample=i + 1, total=total, acc=acc, wt=wt, film=film))
    return film, acc, wt


def _render_pooled(
    scene, film, camera, cfg, rows, acc, wt, data, keys,
    start_sample, total, chunks, on_progress, seed=0,
):
    """Host loop of the survivor-pool scheduler (deep-bounce scenes)."""
    stage, empty_pool, make_flush_step, make_shrink, expose_pool, snap_pool = (
        make_pooled_steps(scene, film, camera, cfg, rows)
    )
    capacity = rows * film.width
    # the flush plan caps continuation depth at exactly bounces - STAGE
    q, r = divmod(cfg.bounces - STAGE_BOUNCES, CONT_BOUNCES)
    flush_plan = [CONT_BOUNCES] * q + ([r] if r else [])
    flush_fns = {steps: make_flush_step(steps) for steps in set(flush_plan)}
    shrink_fns = {}
    pool = empty_pool()
    fill = 0
    key_counter = [0]
    # flush keys fold the render seed so deep-bounce randomness differs
    # between seeds (a fixed base key would correlate renders past STAGE)
    flush_base = jax.random.fold_in(jax.random.PRNGKey(seed), 0x9E3779B9)

    def next_key():
        key_counter[0] += 1
        return jax.random.fold_in(flush_base, key_counter[0])

    # Flush HBM bound: continuation launches materialize dense-sweep
    # [lanes, prims] x (1 + light_samples) f32 intermediates; at the full
    # POOL_FACTOR x chunk pool width that compiled ~25 GB of temps on
    # diamonds and OOMed. Flushing the pool in fixed-width SEGMENTS (host
    # slices of the pool arrays, each run down its own ladder) bounds the
    # footprint without shrinking the stage chunks (which cost ~17% of
    # diamonds throughput when pick_rows capped them instead) — segments
    # share one set of shape-specialized jits.
    pool_n = POOL_FACTOR * capacity
    per_lane = (1 + cfg.light_samples) * max(scene.num_primitives, 1)
    seg_target = max(film.width, 200_000_000 // per_lane)
    flush_segs = 1
    while flush_segs < POOL_FACTOR and pool_n // flush_segs > seg_target:
        flush_segs *= 2

    def flush(acc, wt, pool, fill):
        """Run the pool to completion down a shrinking width ladder: after
        each continuation launch, if the survivors fit a 4x narrower pool,
        expose the finished lanes and compact — the deep bounce tail (a
        fraction of a percent of lanes by bounce ~100) then runs at a
        narrow width instead of the full pool's."""
        if fill == 0:
            return acc, wt, pool
        seg_n = pool_n // flush_segs
        for g in range(flush_segs):
            if g * seg_n >= fill:
                break  # later segments were never written this cycle
            seg = jax.tree_util.tree_map(
                lambda x: x[g * seg_n : (g + 1) * seg_n], pool
            )
            count = fill - g * seg_n
            for steps in flush_plan:
                seg, n_alive = flush_fns[steps](seg, next_key(), data)
                count = int(n_alive)
                if count == 0:
                    break
                width = seg["valid"].shape[0]
                while width >= 2048 and count <= width // 4:
                    width_to = width // 4
                    if width_to not in shrink_fns:
                        shrink_fns[width_to] = make_shrink(width_to)
                    acc, wt, seg = shrink_fns[width_to](acc, wt, seg, data)
                    width = width_to
            acc, wt = expose_pool(acc, wt, seg)
        return acc, wt, empty_pool()

    # the pool holds POOL_FACTOR x a chunk's lanes; flushing whenever the
    # remaining space could not absorb a worst-case (all-survive) chunk
    # guarantees the in-stage survivor scatter never drops a lane
    order = chunk_order(chunks)
    for i in range(start_sample, total):
        for c in order:
            if fill + capacity > POOL_FACTOR * capacity:
                acc, wt, pool = flush(acc, wt, pool, fill)
                fill = 0
            acc, wt, pool, n_alive = stage(
                acc, wt, pool, fill, keys[i * chunks + c], data, c * rows
            )
            fill += int(n_alive)
        if on_progress is not None:
            # preview snapshot includes pooled survivors' partial sums so the
            # image doesn't jump at (rare) flush boundaries
            p_acc, p_wt = (acc, wt) if fill == 0 else snap_pool(acc, wt, pool)
            on_progress(RenderProgress(sample=i + 1, total=total, acc=p_acc, wt=p_wt, film=film))
    acc, wt, pool = flush(acc, wt, pool, fill)
    return film, acc, wt


def render_sharded(project_data, scene: Scene, mesh, seed: int = 0, on_progress=None, max_samples=None, resume=None):
    """Multi-device rendering: the sample axis is sharded over ``mesh`` (one
    stratified sample per device per step into per-device film shards), and
    the film merge is a single all-reduce at development time. Honors the
    exact requested sample count and checkpoint resume (parallel.run_sharded).
    Deep-bounce budgets take the survivor-pool scheduler with one
    device-resident pool per shard (_render_pooled_sharded)."""
    from ..parallel.mesh import run_sharded

    project = project_data.project
    settings = project.renderer
    film = Film(
        width=project.image.width,
        height=project.image.height,
        bins=settings.spectrum_bins,
        span=settings.spectrum_span,
    )
    camera = CameraModel.from_ir(project.camera)
    cfg = TraceConfig(
        bounces=settings.bounces,
        light_samples=settings.light_samples,
        spectrum_samples=settings.spectrum_samples,
    )
    total = settings.pixel_samples if max_samples is None else min(
        settings.pixel_samples, max_samples
    )

    if regen_enabled() and (not scene.use_clusters or regen_clusters_enabled()):
        rows = pick_rows(film, scene, cfg)
        return _render_regen_sharded(
            scene, film, camera, cfg, rows, mesh, seed, total,
            on_progress=on_progress, resume=resume,
        )

    if cfg.bounces >= POOL_MIN_BOUNCES:
        rows = pick_rows(film, scene, cfg, bounces=STAGE_BOUNCES)
        return _render_pooled_sharded(
            scene, film, camera, cfg, rows, mesh, seed, total,
            on_progress=on_progress, resume=resume,
        )

    rows = pick_rows(film, scene, cfg)
    step = make_render_step(scene, film, camera, cfg, rows=rows, jit=False)
    return run_sharded(
        step,
        film,
        mesh,
        scene.device_data(),
        total,
        seed=seed,
        chunks=film.height // rows,
        rows=rows,
        on_progress=on_progress,
        resume=resume,
        progress_cls=RenderProgress,
    )


def _render_regen_sharded(
    scene, film, camera, cfg, rows, mesh, seed, total, on_progress=None, resume=None
):
    """Path-regeneration over the device mesh: every device runs its own
    regen wavefront (lanes own the same pixels on every device; the sample
    axis is sharded), with per-device sample targets riding in as a sharded
    [D, n] array — so the exact requested sample count is honored even when
    it doesn't divide by the device count (lanes trace past quota for
    occupancy but the extras never expose, see make_regen_step). Quotas are
    balanced per device lane from measured completion rates and each launch
    exits at the <=1% soft tail, exactly as in _render_regen. Film merge
    stays the single psum at development time (parallel/mesh.py
    semantics)."""
    import numpy as np
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..parallel.mesh import device_film_buffers, merge_films, step_keys

    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    data = scene.device_data()
    chunks = film.height // rows
    planes = _regen_planes(film, rows, scene.use_clusters, scene=scene)
    pix = rows * film.width
    n = pix * planes

    step_raw = make_regen_step(scene, film, camera, cfg, rows=rows, planes=planes, jit=False)

    def per_device(acc, wt, keys, spp_lane, tail, data, row0):
        acc2, wt2, _, ex, dn = step_raw(
            acc[0], wt[0], keys[0], data, row0, spp_lane[0], tail[0]
        )
        return acc2[None], wt2[None], ex[None], dn[None]

    sharded = jax.jit(
        shard_map(
            per_device,
            mesh=mesh,
            in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis), P(), P()),
            out_specs=(P(axis), P(axis), P(axis), P(axis)),
            check_vma=False,
        ),
        donate_argnums=(0, 1),
    )

    start = 0
    resume_films = None
    if resume is not None:
        resume_films = (resume["acc"], resume["wt"])
        start = resume["samples_done"]
    acc, wt = device_film_buffers(film, mesh, resume=resume_films)
    spp_sharding = NamedSharding(mesh, P(axis))

    lane_chunk = 64 if (scene.use_clusters or cfg.bounces >= POOL_MIN_BOUNCES) else 40
    key = jax.random.PRNGKey(seed)
    order = chunk_order(chunks)
    # per-device, per-lane remaining counts: devices then planes split the
    # per-pixel request
    rem = np.zeros((chunks, n_dev, n), np.int32)
    dev_base, dev_extra = divmod(total - start, n_dev)
    for d in range(n_dev):
        dev_take = dev_base + (1 if d < dev_extra else 0)
        b, r = divmod(dev_take, planes)
        v = np.full(planes, b, np.int32)
        v[:r] += 1
        rem[:, d, :] = np.repeat(v, pix)[None]
    rate = [[None] * n_dev for _ in range(chunks)]
    rnd = 0
    cur_chunk = max(4, lane_chunk // 8)  # ramp-up as in _render_regen
    while rem.any():
        for ci in order:
            if not rem[ci].any():
                continue
            quota = np.stack([
                adaptive_quotas(rem[ci, d], rate[ci][d], cur_chunk)
                for d in range(n_dev)
            ])
            tails = np.zeros(n_dev, np.int32)
            for d in range(n_dev):
                active = int((quota[d] > 0).sum())
                tails[d] = min(n // 100, active - 1) if active > 1 else 0
            keys = step_keys(key, n_dev, (rnd + start) * chunks + ci)
            acc, wt, ex, dn = sharded(
                acc, wt, keys,
                jax.device_put(quota, spp_sharding),
                jax.device_put(tails, spp_sharding),
                data, ci * rows,
            )
            dn_h = np.asarray(dn)
            ex_h = np.asarray(ex)
            rem[ci] -= np.minimum(dn_h, quota)
            for d in range(n_dev):
                iters = max(float(ex_h[d]) / n, 1.0)
                fresh = np.maximum(dn_h[d].astype(np.float32), 0.25) / iters
                rate[ci][d] = (
                    fresh if rate[ci][d] is None else 0.5 * (rate[ci][d] + fresh)
                )
        rnd += 1
        cur_chunk = min(lane_chunk, cur_chunk * 2)
        if on_progress is not None:
            worst = int(
                np.max(rem.reshape(chunks, n_dev * planes, pix).sum(axis=1))
            )
            merged_acc, merged_wt = merge_films(acc, wt)
            on_progress(RenderProgress(
                sample=total - worst, total=total,
                acc=merged_acc, wt=merged_wt, film=film,
            ))
    merged_acc, merged_wt = merge_films(acc, wt)
    return film, merged_acc, merged_wt


def _render_pooled_sharded(
    scene, film, camera, cfg, rows, mesh, seed, total, on_progress=None, resume=None
):
    """Survivor-pool scheduling over the device mesh: each shard keeps its
    own ray pool; the host drives all shards in lockstep, flushing whenever
    the fullest shard's pool could overflow (per-device fill counts ride
    back as a [D] array per stage). Film merge stays the single psum at
    development time (parallel/mesh.py semantics)."""
    import numpy as np
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..parallel.mesh import device_film_buffers, merge_films, step_keys

    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    data = scene.device_data()
    chunks = film.height // rows
    capacity = rows * film.width

    stage_raw, empty_pool, make_flush_raw, make_shrink_raw, expose_raw, _ = (
        make_pooled_steps(scene, film, camera, cfg, rows, jit=False)
    )

    start = 0
    resume_films = None
    if resume is not None:
        resume_films = (resume["acc"], resume["wt"])
        start = resume["samples_done"]
    acc, wt = device_film_buffers(film, mesh, resume=resume_films)

    def rep1(tree):
        return jax.tree_util.tree_map(lambda x: x[None], tree)

    def take0(tree):
        return jax.tree_util.tree_map(lambda x: x[0], tree)

    def per_device_stage(acc, wt, pool, fill, keys, enabled, data, row0):
        acc2, wt2, pool2, n_alive = stage_raw(
            acc[0], wt[0], take0(pool), fill[0], keys[0], data, row0
        )
        keep = enabled[0]
        acc2 = jnp.where(keep, acc2, acc[0])
        wt2 = jnp.where(keep, wt2, wt[0])
        pool2 = jax.tree_util.tree_map(
            lambda new, old: jnp.where(keep, new, old[0]), pool2, pool
        )
        n_alive = jnp.where(keep, n_alive, 0)
        return acc2[None], wt2[None], rep1(pool2), n_alive[None]

    sharded_stage = jax.jit(
        shard_map(
            per_device_stage,
            mesh=mesh,
            in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis), P(axis), P(), P()),
            out_specs=(P(axis), P(axis), P(axis), P(axis)),
            check_vma=False,
        ),
        donate_argnums=(0, 1, 2),
    )

    flush_fns = {}

    def sharded_flush(steps):
        if steps not in flush_fns:
            raw = make_flush_raw(steps)

            def per_device(pool, keys, data):
                pool2, n_alive = raw(take0(pool), keys[0], data)
                return rep1(pool2), n_alive[None]

            flush_fns[steps] = jax.jit(
                shard_map(
                    per_device, mesh=mesh,
                    in_specs=(P(axis), P(axis), P()),
                    out_specs=(P(axis), P(axis)),
                    check_vma=False,
                ),
                donate_argnums=(0,),
            )
        return flush_fns[steps]

    shrink_fns = {}

    def sharded_shrink(width_to):
        if width_to not in shrink_fns:
            raw = make_shrink_raw(width_to)

            def per_device(acc, wt, pool, data):
                acc2, wt2, pool2 = raw(acc[0], wt[0], take0(pool), data)
                return acc2[None], wt2[None], rep1(pool2)

            shrink_fns[width_to] = jax.jit(
                shard_map(
                    per_device, mesh=mesh,
                    in_specs=(P(axis), P(axis), P(axis), P()),
                    out_specs=(P(axis), P(axis), P(axis)),
                    check_vma=False,
                ),
                donate_argnums=(0, 1, 2),
            )
        return shrink_fns[width_to]

    def per_device_expose(acc, wt, pool):
        acc2, wt2 = expose_raw(acc[0], wt[0], take0(pool))
        return acc2[None], wt2[None]

    sharded_expose = jax.jit(
        shard_map(
            per_device_expose, mesh=mesh,
            in_specs=(P(axis), P(axis), P(axis)),
            out_specs=(P(axis), P(axis)),
            check_vma=False,
        ),
        donate_argnums=(0, 1),
    )

    # per-device pools, replicated construction then sharded put
    sharding = NamedSharding(mesh, P(axis))
    pool1 = empty_pool()
    pool = jax.tree_util.tree_map(
        lambda x: jax.device_put(
            jnp.broadcast_to(x[None], (n_dev,) + x.shape), sharding
        ),
        pool1,
    )

    q, r = divmod(cfg.bounces - STAGE_BOUNCES, CONT_BOUNCES)
    flush_plan = [CONT_BOUNCES] * q + ([r] if r else [])
    key = jax.random.PRNGKey(seed)
    flush_base = jax.random.fold_in(jax.random.PRNGKey(seed), 0x9E3779B9)
    key_counter = [0]

    def next_keys():
        key_counter[0] += 1
        return jax.random.split(
            jax.random.fold_in(flush_base, key_counter[0]), n_dev
        )

    def flush(acc, wt, pool, fills):
        if int(fills.max()) == 0:
            return acc, wt, pool, np.zeros(n_dev, np.int64)
        count = int(fills.max())
        for steps in flush_plan:
            pool, n_alive = sharded_flush(steps)(pool, next_keys(), data)
            count = int(np.asarray(n_alive).max())
            if count == 0:
                break
            width = pool["valid"].shape[1]
            while width >= 2048 and count <= width // 4:
                width_to = width // 4
                acc, wt, pool = sharded_shrink(width_to)(acc, wt, pool, data)
                width = width_to
        acc, wt = sharded_expose(acc, wt, pool)
        fresh = jax.tree_util.tree_map(
            lambda x: jax.device_put(
                jnp.broadcast_to(x[None], (n_dev,) + x.shape), sharding
            ),
            empty_pool(),
        )
        return acc, wt, fresh, np.zeros(n_dev, np.int64)

    lane = np.arange(n_dev)
    fills = np.zeros(n_dev, np.int64)
    done = start
    group = -(-start // n_dev)
    order = chunk_order(chunks)
    while done < total:
        take = min(n_dev, total - done)
        enabled = jnp.asarray(lane < take)
        for c in order:
            if int(fills.max()) + capacity > POOL_FACTOR * capacity:
                acc, wt, pool, fills = flush(acc, wt, pool, fills)
            keys = step_keys(key, n_dev, group * chunks + c)
            acc, wt, pool, n_alive = sharded_stage(
                acc, wt, pool, jnp.asarray(fills, jnp.int32), keys, enabled,
                data, jnp.int32(c * rows),
            )
            fills = fills + np.asarray(n_alive, np.int64)
        done += take
        group += 1
        if on_progress is not None:
            m_acc, m_wt = merge_films(acc, wt)
            on_progress(RenderProgress(sample=done, total=total, acc=m_acc, wt=m_wt, film=film))
    acc, wt, pool, fills = flush(acc, wt, pool, fills)
    m_acc, m_wt = merge_films(acc, wt)
    return film, m_acc, m_wt
