"""Benchmarks: the three BASELINE.md tracked metrics plus the two headline
workload classes (simple + BDPT + large mesh).

Prints ONE JSON line; the primary metric is steady-state trace throughput on
the reference spheres scene, with the other entries under "extras":
  - trace throughput, spheres 512x256 simple (Mrays/sec/chip, LIVE lanes)
  - sampling rate, cornell 512x512 BDPT (spp/sec at 512^2)
  - time-to-noise-target, spheres (seconds until consecutive previews differ
    by < 2/255 mean absolute luminance)
  - trace throughput, synthetic 328k-tri terrain (dragon-class large mesh)

Ray accounting counts LIVE lanes only: an un-timed instrumented pass sums the
path rays whose `alive` mask is set entering each bounce (each of which also
spawns `light_samples` shadow rays); terminated lanes' masked work is not
credited.

Every timed window ends in jax.block_until_ready. Every result line names
the device it ran on; the bench refuses to run without a GPU. The scene
paths below point at the reference checkout's scene files, which this
repository does not hold yet.
"""

import json
import sys
import time


def _steady_time(step_fn, acc, wt, keys, data):
    """Time len(keys) steps, ending in block_until_ready; returns (s/step, acc, wt)."""
    import jax

    t0 = time.time()
    for k in keys:
        acc, wt = step_fn(acc, wt, k, data)
    jax.block_until_ready((acc, wt))
    return (time.time() - t0) / len(keys), acc, wt


def _build(scene_path):
    from pyrite_tpu.film import Film
    from pyrite_tpu.project import load_project
    from pyrite_tpu.scene import CameraModel, build_scene
    from pyrite_tpu.tracer import TraceConfig

    project_data = load_project(scene_path)
    scene = build_scene(project_data)
    settings = project_data.project.renderer
    film = Film(
        width=project_data.project.image.width,
        height=project_data.project.image.height,
        bins=settings.spectrum_bins,
        span=settings.spectrum_span,
    )
    camera = CameraModel.from_ir(project_data.project.camera)
    cfg = TraceConfig(
        bounces=settings.bounces,
        light_samples=settings.light_samples,
        spectrum_samples=settings.spectrum_samples,
    )
    return project_data, scene, film, camera, cfg


def _rays_per_step(scene, film, camera, cfg, key, rows, batch=1):
    """Instrumented (un-timed) pass over one render step. Returns
    (live, executed): live sums path rays whose `alive` mask is set entering
    each bounce; executed sums whole-wavefront lane-bounces actually run
    (the bounce loop exits once every lane is dead — tracer.trace_paths).
    Both count 1 extension + light_samples shadow rays per lane-bounce.
    ``batch``: stratified samples traced per launch (the megabatched step) —
    the instrumented wavefront concatenates that many sample chunks, just
    like simple.make_render_step."""
    import jax
    import jax.numpy as jnp

    from pyrite_tpu import tracer
    from pyrite_tpu.renderers.simple import chunk_rays

    def stats(key, data):
        with scene.bind(data):
            live_total = jnp.zeros((), jnp.float32)
            exec_total = jnp.zeros((), jnp.float32)
            chunks = film.height // rows
            for c in range(chunks):
                k_c = jax.random.fold_in(key, c)
                parts = [
                    chunk_rays(
                        film, camera, cfg, jax.random.fold_in(k_c, s),
                        row0=c * rows, rows=rows,
                    )
                    for s in range(batch)
                ]
                origin = jnp.concatenate([p[1] for p in parts], axis=0)
                direction = jnp.concatenate([p[2] for p in parts], axis=0)
                wavelengths = jnp.concatenate([p[3] for p in parts], axis=0)
                n, s = wavelengths.shape
                state = {
                    "origin": origin,
                    "direction": direction,
                    "brightness": jnp.zeros((n, s)),
                    "reflectance": jnp.ones((n, s)),
                    "alive": jnp.ones(n, bool),
                    "aux_alive": jnp.ones(n, bool),
                    "sample_light": jnp.ones(n, bool),
                    "light_events": jnp.zeros(n, jnp.int32),
                }
                k_t = jax.random.fold_in(k_c, 7)

                def cond(carry):
                    i, state, live, executed = carry
                    return (i < cfg.bounces) & jnp.any(state["alive"])

                def body(carry):
                    i, state, live, executed = carry
                    live = live + jnp.sum(state["alive"].astype(jnp.float32))
                    executed = executed + n
                    new_state, _ = tracer.bounce_core(
                        scene, cfg, wavelengths, state, jax.random.fold_in(k_t, i)
                    )
                    return i + 1, new_state, live, executed

                _, _, live, executed = jax.lax.while_loop(
                    cond, body,
                    (jnp.int32(0), state, jnp.float32(0), jnp.float32(0)),
                )
                live_total = live_total + live
                exec_total = exec_total + executed
            return live_total, exec_total

    live, executed = jax.jit(stats)(key, scene.device_data())
    scale = 1 + cfg.light_samples
    return float(live) * scale, float(executed) * scale


def bench_simple(scene_path, steps=10):
    """Steady-state Mrays/s on a simple-renderer scene.

    Returns (live_mrays, executed_mrays): live counts only path rays whose
    `alive` mask is set entering each bounce (plus their shadow rays);
    executed counts every lane-bounce the wavefront actually runs (masked
    work included; whole-wavefront early exit excluded)."""
    import jax
    import jax.numpy as jnp

    from pyrite_tpu.renderers.simple import (
        make_render_step, pick_rows, pick_sample_batch,
    )

    _, scene, film, camera, cfg = _build(scene_path)
    rows = pick_rows(film, scene, cfg)
    batch = pick_sample_batch(film, scene, cfg, rows)
    step = make_render_step(scene, film, camera, cfg, rows=rows, samples=batch)
    chunks = film.height // rows

    acc, wt = film.new_buffers()
    data = scene.device_data()
    key = jax.random.PRNGKey(0)

    live_rays, executed_rays = _rays_per_step(
        scene, film, camera, cfg, key, rows, batch=batch
    )

    # pre-split all step keys on the host so the timed loop dispatches only
    # the render steps
    import numpy as np

    all_keys = np.asarray(jax.random.split(key, (steps + 1) * chunks * batch))

    def group(i, c):
        base = (i * chunks + c) * batch
        ks = all_keys[base : base + batch]
        return jnp.asarray(ks) if batch > 1 else ks[0]

    def full_step(acc, wt, ks, data):
        for c in range(chunks):
            acc, wt = step(acc, wt, ks[c], data, c * rows)
        return acc, wt

    # warm every chunk shape, then time
    acc, wt = full_step(acc, wt, [group(0, c) for c in range(chunks)], data)
    jax.block_until_ready((acc, wt))
    keys = [[group(i + 1, c) for c in range(chunks)] for i in range(steps)]
    per_step, acc, wt = _steady_time(full_step, acc, wt, keys, data)
    return live_rays / per_step / 1e6, executed_rays / per_step / 1e6


def _regen_bench_loop(scene_path, spp, reps):
    """Shared regen-bench harness mirroring simple._render_regen's adaptive
    quota loop: one uniform warm round learns per-lane completion rates,
    one adaptive warm round reaches the steady-state quota distribution,
    then ``reps`` timed adaptive rounds. Returns a stats dict with the raw
    sums."""
    import jax
    import numpy as np

    from pyrite_tpu.renderers.simple import (
        _regen_planes, adaptive_quotas, make_regen_step, pick_rows,
    )

    _, scene, film, camera, cfg = _build(scene_path)
    rows = pick_rows(film, scene, cfg)
    planes = _regen_planes(film, rows, scene.use_clusters)
    chunks = film.height // rows
    pix = rows * film.width
    n = pix * planes
    step = make_regen_step(scene, film, camera, cfg, rows=rows, planes=planes)

    data = scene.device_data()
    acc, wt = film.new_buffers()
    lane_spp = max(1, spp // planes)
    rem = np.full(n, 10**6, np.int32)  # throughput bench: never exhausted
    rate = [None] * chunks
    max_reps = reps + 3  # agreement retries (see below)
    keys = np.asarray(
        jax.random.split(jax.random.PRNGKey(0), (max_reps + 2) * chunks)
    )

    def launch(r, c):
        nonlocal acc, wt
        quota = adaptive_quotas(rem, rate[c], lane_spp)
        # soft tail as in _render_regen: leave <=1% of lanes short per
        # launch (their samples are NOT counted — realized completions only)
        acc, wt, lv, ex, dn = step(
            acc, wt, keys[r * chunks + c], data, c * rows, quota,
            np.int32(n // 100),
        )
        ex_f = float(ex)
        dn_h = np.asarray(dn)
        fresh = np.maximum(dn_h.astype(np.float32), 0.25) / max(ex_f / n, 1.0)
        rate[c] = fresh if rate[c] is None else 0.5 * (rate[c] + fresh)
        return float(lv), ex_f, float(np.minimum(dn_h, quota).sum())

    # warm: uniform round (learns rates), then one adaptive round
    for r in range(2):
        for c in range(chunks):
            launch(r, c)

    # timed reps are measured INDIVIDUALLY and must agree within 10%
    # before the entry is emitted — first-flush compile contamination and
    # transient stalls are retried away instead of skewing the result
    rep_stats = []
    r = 0
    while r < max_reps:
        t0 = time.time()
        lv_r = ex_r = q_r = 0.0
        for c in range(chunks):
            lv, ex, q = launch(r + 2, c)
            lv_r += lv
            ex_r += ex
            q_r += q
        # the per-launch done-fetch already forces each launch
        rep_stats.append((lv_r, ex_r, q_r, time.time() - t0))
        r += 1
        if len(rep_stats) >= reps:
            rates = [s[0] / s[3] for s in rep_stats[-reps:]]
            if max(rates) <= 1.10 * min(rates):
                break
    tail = rep_stats[-reps:]
    lvs = sum(s[0] for s in tail)
    exs = sum(s[1] for s in tail)
    samples = sum(s[2] for s in tail)
    dt = sum(s[3] for s in tail)
    return {
        "live": lvs,
        "executed": exs,
        "samples": samples,
        "dt": dt,
        "light_samples": cfg.light_samples,
        "pixels": film.width * film.height,
    }


def bench_simple_regen(scene_path, spp=640, reps=3):
    """Steady-state Mrays/s of the path-regeneration scheduler (the simple
    renderer's default path for dense scenes): dead lanes restart a fresh
    sample in place and per-lane quotas are depth-balanced, so occupancy
    stays high at any bounce depth. The regen step itself counts live and
    executed lane-bounces (live = quota-bound lanes only; discarded
    overshoot extras are NOT credited); returns (live_mrays,
    executed_mrays) with NEE shadow rays credited like bench_simple."""
    st = _regen_bench_loop(scene_path, spp, reps)
    scale = 1 + st["light_samples"]
    live = st["live"] * scale / st["dt"] / 1e6
    executed = st["executed"] * scale / st["dt"] / 1e6
    return live, executed


def bench_regen_spp(scene_path, spp=16, reps=2):
    """Steady-state samples/sec of the regeneration scheduler on a full
    scene (deep-bounce dense scenes like diamonds): times ``reps`` adaptive
    rounds of ~``spp`` samples each after two warm rounds."""
    st = _regen_bench_loop(scene_path, spp, reps)
    # samples is the per-lane quota sum = exposed samples across the film
    return st["samples"] / st["pixels"] / st["dt"]


def bench_time_to_noise(scene_path, threshold=2.0 / 255.0, max_spp=96, check_every=4):
    """Seconds of rendering until consecutive previews (every ``check_every``
    samples) differ by < threshold mean absolute luminance — the practical
    'image has stopped changing' target."""
    import numpy as np

    from pyrite_tpu.renderers import simple as mod

    project_data, scene, film, camera, cfg = _build(scene_path)

    state = {"t0": None, "prev": None, "answer": None}

    def on_progress(progress):
        if state["t0"] is None:
            state["t0"] = time.time()  # first sample done: compile excluded
        if state["answer"] is not None or progress.sample % check_every:
            return
        img = np.asarray(
            progress.film.to_image(progress.acc, progress.wt, 30.0, None)
        ).astype(np.float32).mean(axis=2) / 255.0
        if state["prev"] is not None:
            delta = np.abs(img - state["prev"]).mean()
            if delta < threshold:
                state["answer"] = time.time() - state["t0"]
        state["prev"] = img

    mod.render(project_data, scene, seed=0, on_progress=on_progress, max_samples=max_spp)
    return state["answer"] if state["answer"] is not None else float("nan")


def bench_render_spp(scene_path, algorithm="bidirectional", samples=4, warm=1):
    """Steady-state spp/s of a full renderer on a reference scene; the first
    ``warm`` progress reports (jit compiles) are excluded from the rate.
    Progress may arrive once per multi-sample launch (the regeneration
    schedulers), so the rate uses reported sample-count deltas, not
    callback counts."""
    import importlib

    import jax

    from pyrite_tpu.project import load_project
    from pyrite_tpu.scene import build_scene

    mod = importlib.import_module(f"pyrite_tpu.renderers.{algorithm}")
    project_data = load_project(scene_path)
    scene = build_scene(project_data)
    times = []
    counts = []

    def on_progress(progress):
        # dispatch is asynchronous: wait for the film before timestamping
        jax.block_until_ready(progress.acc)
        times.append(time.time())
        counts.append(progress.sample)

    mod.render(
        project_data, scene, seed=0, on_progress=on_progress, max_samples=samples
    )
    if len(times) < warm + 2:
        return float("nan")
    # steady-state check: when the early post-warm intervals still carry
    # compile/variant contamination (first vs second half disagree >10%),
    # report the LATER half's rate instead of the blended one
    mid = (warm + len(times)) // 2
    if mid > warm and mid < len(times) - 1:
        r1 = (counts[mid] - counts[warm]) / max(times[mid] - times[warm], 1e-9)
        r2 = (counts[-1] - counts[mid]) / max(times[-1] - times[mid], 1e-9)
        if max(r1, r2) > 1.10 * max(min(r1, r2), 1e-9):
            return r2
    return (counts[-1] - counts[warm]) / (times[-1] - times[warm])


def bench_terrain(steps=3):
    """Steady-state live-lane Mrays/s on the synthetic 328k-triangle terrain
    (dragon-class large mesh; the reference's dragon OBJ is stripped).
    Returns (live_mrays, tris)."""
    import tempfile

    import sys
    sys.path.insert(0, __file__.rsplit("/", 1)[0])
    from tools.synthetic import terrain_scene

    lua, tris = terrain_scene(
        tempfile.mkdtemp(), cells=405, width=256, height=128, spp=8, bounces=4
    )
    # the render default for cluster scenes is the regen scheduler
    from pyrite_tpu.renderers.simple import regen_clusters_enabled

    if regen_clusters_enabled():
        return bench_simple_regen(lua, spp=64, reps=2)[0], tris
    return bench_simple(lua, steps=steps)[0], tris


def bench_dragon_bdpt(samples=8):
    """Steady-state spp/s of the dragon workload class: 871k-triangle mesh,
    BDPT with bounces 20 / light_bounces 256 (the reference's dragon.lua
    configuration over the synthetic heightfield — the real OBJ is a
    stripped blob). Exercises the staged camera walk, the staged
    deferred-connection finish, and the wide-BVH cluster traversal.

    Samples are minutes each (every camera bounce folds ~K'=256 lamp
    connections per lane), so the rate is taken from the FIRST to the
    LAST progress report (launch 2 of 2 at chunk 2: compile-free steady
    state) instead of bench_render_spp's warm+2 scheme."""
    import tempfile
    import time as _time

    import jax

    import sys
    sys.path.insert(0, __file__.rsplit("/", 1)[0])
    from tools.synthetic import dragon_scene
    from pyrite_tpu.project import load_project
    from pyrite_tpu.scene import build_scene
    from pyrite_tpu.renderers import bidirectional as B

    lua, tris = dragon_scene(tempfile.mkdtemp(), cells=660)
    pd = load_project(lua)
    scene = build_scene(pd)
    marks = []

    def on_progress(progress):
        jax.block_until_ready(progress.acc)
        marks.append((progress.sample, _time.time()))

    B.REGEN_BDPT_SPP_CHUNK = 2
    try:
        B.render(pd, scene, seed=0, on_progress=on_progress, max_samples=samples)
    finally:
        B.REGEN_BDPT_SPP_CHUNK = 32
    if len(marks) < 2:
        return None, tris
    # steady state = the LAST inter-mark segment when one exists: earlier
    # launches can still compile per-lamp-count compact/splat bucket
    # variants (k_new is data-dependent)
    (s0, t0), (s1, t1) = (
        marks[-2] if len(marks) >= 3 else marks[0]
    ), marks[-1]
    if t1 - t0 <= 0:
        # near-simultaneous marks: no NaN in the JSON line (json.dumps
        # would emit non-standard NaN and break the driver's parse)
        return None, tris
    return (s1 - s0) / (t1 - t0), tris


def main():
    """Run the suite under a global wall-clock budget, emitting the result
    line INCREMENTALLY: the primary (spheres regen throughput) is printed
    and flushed the moment it lands, and the full line is re-printed after
    every additional entry. A reader takes the LAST JSON line, so a
    timeout anywhere loses only the not-yet-run entries. Each entry
    declares a conservative time
    reservation and is skipped (with the reason recorded) when the
    remaining budget cannot cover it."""
    import os

    import jax

    from pyrite_tpu.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: needs a GPU, JAX found {dev.platform!r}", file=sys.stderr)
        sys.exit(2)
    device = {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
    }
    enable_compile_cache()

    # generous default: incremental emission means an external kill only
    # loses not-yet-run entries, so the budget is set by the heaviest
    # useful entry (dragon) rather than fear of timeouts
    budget = float(os.environ.get("PYRITE_TPU_BENCH_BUDGET", "3600"))
    t_start = time.time()
    extras = []

    spheres = "/root/reference/pyrite/test/spheres/spheres.lua"
    cornell = "/root/reference/pyrite/test/cornell/cornell.lua"

    mrays, executed_mrays = bench_simple_regen(spheres)
    result = {
        "metric": "trace throughput, spheres 512x256 simple renderer "
        "(live lanes only)",
        "value": mrays,
        "unit": "Mrays/sec/chip",
        "device": device,
        "extras": extras,
    }

    def emit():
        print(json.dumps(result), flush=True)

    extras.append(
        {
            "metric": "trace throughput, spheres, regen executed lane-bounces "
            "(including regen-tail masked work)",
            "value": executed_mrays,
            "unit": "Mrays/sec/chip",
        }
    )
    emit()

    def remaining():
        return budget - (time.time() - t_start)

    def entry(name, need, fn):
        """Run one budgeted entry and re-emit the full result line."""
        if remaining() < need:
            extras.append(
                {
                    "metric": name,
                    "skipped": f"time budget: {remaining():.0f}s remaining "
                    f"< {need:.0f}s reserved",
                }
            )
        else:
            try:
                value = fn()
                extras.extend(value if isinstance(value, list) else [value])
            except Exception as error:  # never lose the primary line
                extras.append({"metric": name, "error": repr(error)})
        emit()

    def cornell_entry():
        return {
            "metric": "sampling rate, cornell 512x512 bidirectional",
            "value": bench_render_spp(cornell),
            "unit": "spp/sec",
        }

    def terrain_entry():
        terrain_mrays, tris = bench_terrain()
        return {
            "metric": f"trace throughput, synthetic terrain {tris} tris simple",
            "value": terrain_mrays,
            "unit": "Mrays/sec/chip",
        }

    def diamonds_entry():
        # 256-bounce dispersion scene on the regeneration scheduler (dead
        # lanes restart fresh samples in place; one compile for any spp).
        # spp=192 = the renderer's default 64-samples-per-lane launch over
        # the film's sample planes
        diamonds = "/root/reference/pyrite/test/diamonds/diamonds.lua"
        return {
            "metric": "sampling rate, diamonds 512x300 simple "
            "(256 bounces, path-regeneration scheduler)",
            "value": bench_regen_spp(diamonds, spp=192, reps=2),
            "unit": "spp/sec",
        }

    def dragon_entry():
        dragon_spp, dragon_tris = bench_dragon_bdpt()
        if dragon_spp is None:
            raise RuntimeError("dragon: fewer than 2 progress marks")
        return {
            "metric": f"sampling rate, synthetic dragon-class {dragon_tris} "
            "tris bidirectional (20/256 bounces)",
            "value": dragon_spp,
            "unit": "spp/sec",
        }

    def oneshot_entry():
        oneshot_mrays, _ = bench_simple(spheres)
        return {
            "metric": "trace throughput, spheres, one-shot wavefront "
            "(live lanes; the pre-regen r02 primary)",
            "value": oneshot_mrays,
            "unit": "Mrays/sec/chip",
        }

    def ttn_entry():
        return {
            "metric": "time to noise target, spheres 512x256 "
            "(consecutive previews < 2/255 mean |delta|)",
            "value": bench_time_to_noise(spheres),
            "unit": "seconds",
        }

    # importance order: cornell and terrain first, then dragon, then the
    # corroborating entries
    entry("cornell bdpt spp/sec", 240, cornell_entry)
    entry("terrain Mrays/sec", 240, terrain_entry)
    entry("dragon-class bdpt spp/sec", 1200, dragon_entry)
    entry("diamonds spp/sec", 180, diamonds_entry)
    entry("one-shot spheres Mrays/sec", 120, oneshot_entry)
    entry("time-to-noise seconds", 120, ttn_entry)


if __name__ == "__main__":
    main()
