#!/usr/bin/env python3
"""Bring-up smoke check: the render path on one GPU, end to end.

    python chip_smoke.py               # one card: kernels + four renders
    python chip_smoke.py --four-cards  # --multi-device on 4 cards vs 1

Everything runs in this one process (one JAX process per card). The
renders go through the normal entry point, ``pyrite_tpu.cli.main``, with
scenes written here in code. Each phase raises on failure; the last line
of standard output is a JSON object with the device JAX reports, printed
only when every phase passed. With no GPU the script exits non-zero
before any phase.

Times printed here are bring-up observations on the named card, not
benchmark results.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# ---- scenes ------------------------------------------------------------------

# Spheres configuration (512x256, 10 lambda samples, light_samples 4,
# 8 bounces) over a dense scene: ground sphere, an emissive D65 ball in the
# middle, a mirror/diffuse mix to its left and a dispersive glass ball to
# its right.
SPHERES_SRC = """
local ball = shape.sphere {radius = 1.5, position = vector(0, 1.4, 10)}
return {
    image = {width = %(w)d, height = %(h)d},
    camera = camera.perspective {
        fov = 53,
        transform = transform.look_at {from = vector(0, 1, 0), to = vector(0, 1, 1)},
    },
    renderer = renderer.simple {
        pixel_samples = 600,
        spectrum_samples = %(s)d,
        light_samples = 4,
        bounces = %(b)d,
    },
    world = {
        objects = {
            shape.sphere {
                radius = 50.0, position = vector(0, -50, 10),
                material = {surface = material.diffuse {color = 0.8}},
            },
            ball:with{
                material = {surface = material.emissive {color = light_source.d65 * 3}},
            },
            ball:with{
                position = ball.position:with{x = -3},
                material = {
                    surface = mix(material.mirror {color = 1},
                                  material.diffuse {color = rgb(0.2, 0.6, 0.3)},
                                  fresnel(1.5)),
                },
            },
            ball:with{
                position = ball.position:with{x = 3},
                material = {
                    surface = material.refractive {ior = 1.5, dispersion = %(disp)s, color = 1},
                },
            },
        },
    },
}
"""

# Cornell configuration (512x512 BDPT, bounces 4 / light_bounces 4, 10
# lambda samples): a cubic quaternion julia (25 iterations) in a bounding
# box inside a diffuse box, lit by an emissive ball under the ceiling.
CORNELL_SRC = """
local wall = function(origin, normal, color)
    return shape.plane {
        origin = origin, normal = normal,
        material = {surface = material.diffuse {color = color}},
    }
end
return {
    image = {width = %(w)d, height = %(h)d},
    camera = camera.perspective {
        fov = 40,
        transform = transform.look_at {from = vector(0, 1, -4.2), to = vector(0, 1, 0)},
    },
    renderer = renderer.bidirectional {
        pixel_samples = 600,
        spectrum_samples = %(s)d,
        bounces = %(b)d,
        light_bounces = %(b)d,
    },
    world = {
        objects = {
            wall(vector(0, 0, 0), vector(0, 1, 0), 0.75),
            wall(vector(0, 2, 0), vector(0, -1, 0), 0.75),
            wall(vector(0, 0, 1.2), vector(0, 0, -1), 0.75),
            wall(vector(-1.2, 0, 0), vector(1, 0, 0), rgb(0.7, 0.15, 0.1)),
            wall(vector(1.2, 0, 0), vector(-1, 0, 0), rgb(0.15, 0.6, 0.15)),
            shape.sphere {
                radius = 0.25, position = vector(0, 1.85, 0),
                material = {surface = material.emissive {color = light_source.d65 * 8}},
            },
            shape.ray_marched {
                shape = ray_marched.quaternion_julia {
                    iterations = 25,
                    threshold = 4,
                    constant = vector(-0.2, 0.8, 0, 0),
                    slice_plane = 0,
                    variant = quaternion_julia.cubic,
                },
                bounds = bounds.box {
                    min = vector(-0.65, 0.05, -0.65),
                    max = vector(0.65, 1.35, 0.65),
                },
                material = {
                    surface = mix(material.mirror {color = 1},
                                  material.diffuse {color = rgb(0.8, 0.6, 0.35)},
                                  fresnel(1.45)),
                },
            },
        },
    },
}
"""

# Photon-mapping sanity scene: the spheres scene, small.
PHOTON_SRC = SPHERES_SRC.replace(
    "renderer.simple {", "renderer.photon_mapping {"
).replace(
    "light_samples = 4,",
    "light_samples = 4, photons = %(photons)d, photon_bounces = %(pb)d, radius = 0.4,",
)


def spheres_scene(w=512, h=256, s=10, b=8, dispersion=0.01):
    return SPHERES_SRC % {"w": w, "h": h, "s": s, "b": b, "disp": dispersion}


def cornell_scene(w=512, h=512, s=10, b=4):
    return CORNELL_SRC % {"w": w, "h": h, "s": s, "b": b}


def photon_scene(w=128, h=128, s=10, b=8, photons=400, pb=2):
    return PHOTON_SRC % {
        "w": w, "h": h, "s": s, "b": b, "disp": 0.01, "photons": photons, "pb": pb,
    }


def terrain_scene(tmpdir, w=512, h=256, b=4, cells=405):
    """The synthetic 328,050-triangle heightfield (tools/synthetic.py)."""
    sys.path.insert(0, ROOT)
    from tools.synthetic import terrain_scene as make

    path, tris = make(tmpdir, cells=cells, width=w, height=h, bounces=b)
    return path, tris


# ---- helpers -----------------------------------------------------------------


def require_gpu():
    """Exit non-zero unless JAX's first device is a GPU."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(
            f"chip_smoke: needs a GPU, JAX found {devices[0].platform!r}",
            file=sys.stderr,
        )
        sys.exit(2)
    return devices


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


class CompileClock:
    """Records JAX's lowering and backend-compile durations (seconds), each
    with the time it ended, and the persistent cache's hits and misses."""

    EVENTS = {
        "/jax/core/compile/jaxpr_to_mlir_module_duration": "lower",
        "/jax/core/compile/backend_compile_duration": "backend",
    }

    def __init__(self):
        import jax

        self.events = []
        jax.monitoring.register_event_duration_secs_listener(self._on_event)
        jax.monitoring.register_event_listener(self._on_cache_event)

    def _on_event(self, event, duration, **_):
        if event in self.EVENTS:
            self.events.append((time.perf_counter(), self.EVENTS[event], duration))

    def _on_cache_event(self, event, **_):
        if event in ("/jax/compilation_cache/cache_hits", "/jax/compilation_cache/cache_misses"):
            self.events.append((time.perf_counter(), event.rsplit("_", 1)[-1], 0.0))

    def count(self, start, end, kind):
        return sum(1 for ended, k, _ in self.events if start < ended <= end and k == kind)

    def within(self, start, end, kind=None):
        return sum(
            d for ended, k, d in self.events
            if start < ended <= end and kind in (None, k)
        )


def peak_bytes():
    import jax

    return jax.devices()[0].memory_stats().get("peak_bytes_in_use")


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def run_cli(tag, scene_path, args, clock, workdir):
    """One render through cli.main; returns (film acc, wt, image, times)."""
    from pyrite_tpu import cli
    from pyrite_tpu.png import read_png

    out = os.path.join(workdir, f"{tag}.png")
    ckpt = os.path.join(workdir, f"{tag}.npz")
    check(not os.path.exists(ckpt), f"{tag}: a render with this tag already ran")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(
            [scene_path, "--output", out, "--checkpoint", ckpt,
             "--preview-interval", "1e9", *args]
        )
    wall = time.perf_counter() - t0
    log = buf.getvalue()
    check(rc == 0, f"{tag}: cli exit code {rc}\n{log}")
    times = {"wall_s": wall}
    for key, name in (("Project loading", "load_s"), ("Rendering", "render_wall_s")):
        found = re.search(rf"^{key}: ([0-9.]+)s$", log, re.MULTILINE)
        check(found is not None, f"{tag}: no '{key}' time in the CLI output")
        times[name] = float(found.group(1))
    check(os.path.exists(out), f"{tag}: no PNG written")
    image = read_png(out)
    check(image.ndim == 3 and image.shape[2] == 3, f"{tag}: PNG shape {image.shape}")
    film = np.load(ckpt)
    acc, wt = film["acc"], film["wt"]
    check(float(wt.sum()) > 0.0, f"{tag}: film weight is zero")
    check(np.isfinite(acc).all() and np.isfinite(wt).all(), f"{tag}: NaN/Inf in film")
    # compiles that ended inside the CLI's rendering window (it starts right
    # after loading) belong to the render's first steps
    start = t0 + times["load_s"]
    end = start + times["render_wall_s"]
    times["compile_s"] = clock.within(start, end)
    times["lower_s"] = clock.within(start, end, "lower")
    cache = f"cache hits {clock.count(t0, end, 'hits')} misses {clock.count(t0, end, 'misses')}"
    times["setup_s"] = times["load_s"] + times["compile_s"]
    times["render_s"] = times["render_wall_s"] - times["compile_s"]
    print(
        f"[{tag}] image {image.shape[1]}x{image.shape[0]} "
        f"weight {float(wt.sum()):.6g} setup_s {times['setup_s']:.3f} "
        f"(load {times['load_s']:.3f} + compile {times['compile_s']:.3f}, "
        f"of which lowering {times['lower_s']:.3f}) "
        f"render_s {times['render_s']:.3f} peak_bytes_in_use {peak_bytes()} {cache}",
        flush=True,
    )
    return acc, wt, image, times


def write_scene(workdir, name, src):
    path = os.path.join(workdir, name)
    with open(path, "w") as fh:
        fh.write(src)
    return path


# ---- phase 2: kernels at real widths -----------------------------------------

MARCH_SHAPES = {
    # cornell's fractal: cubic quaternion julia, 25 iterations
    "julia_cubic": {
        "kind": "quaternion_julia", "iterations": 25, "threshold": 4.0,
        "constant": np.asarray([-0.2, 0.8, 0.0, 0.0], np.float32),
        "slice_plane": 0.0, "variant": "cubic",
    },
    # examples/fractal.lua
    "mandelbulb": {
        "kind": "mandelbulb", "iterations": 12, "threshold": 4.0,
        "power": 8.0, "constant": None,
    },
}


def film_rays(half, res=512):
    """One res x res film of pinhole rays aimed at a [-half, half]^3 box."""
    eye = np.asarray([0.0, 0.0, -3.2 * half], np.float32)
    s = np.linspace(-1.0, 1.0, res, dtype=np.float32) * (1.05 / 3.2)
    gx, gy = np.meshgrid(s, s)
    d = np.stack([gx, gy, np.ones_like(gx)], -1).reshape(-1, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return np.broadcast_to(eye, d.shape).copy(), d.astype(np.float32)


def median_time(fn, args, reps=7):
    import jax

    jax.block_until_ready(fn(*args))  # warm-up
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def phase_march():
    import jax
    import jax.numpy as jnp

    from pyrite_tpu import kernels, tracer
    from pyrite_tpu.scene import DEShape

    half = 1.3
    o_np, d_np = film_rays(half)
    o, d = jnp.asarray(o_np), jnp.asarray(d_np)
    print(f"[march] lanes {o.shape[0]} omega {kernels.de_omega()} "
          f"block {kernels.MARCH_BLOCK} warps {kernels.MARCH_WARPS}")
    results = {}
    for name, est in MARCH_SHAPES.items():
        shape = DEShape(
            estimator=est, bounds_kind="box",
            bounds_a=np.full(3, -half, np.float32),
            bounds_b=np.full(3, half, np.float32), material_id=0,
        )
        outs, secs = {}, {}
        for path in ("kernel", "xla"):
            with kernels.use_path(path):
                fn = jax.jit(
                    lambda o, d: tracer._intersect_de(shape, o, d, 200)[:2]
                )
                compiled = fn.lower(o, d).compile()
            print(f"[march] {name} {path} memory_analysis: "
                  f"{compiled.memory_analysis()}")
            secs[path] = median_time(compiled, (o, d))
            ok, t = compiled(o, d)
            outs[path] = (np.asarray(ok), np.asarray(t))
        (ok_k, t_k), (ok_x, t_x) = outs["kernel"], outs["xla"]
        check(not np.isnan(t_k).any() and not np.isnan(t_x).any(), f"{name}: NaN t")
        agree = float((ok_k == ok_x).mean())
        both = ok_k & ok_x
        close = float((np.abs(t_k[both] - t_x[both]) <= 1e-3).mean()) if both.any() else 1.0
        print(
            f"[march] {name}: kernel_s {secs['kernel']:.6f} xla_s {secs['xla']:.6f} "
            f"speedup {secs['xla'] / secs['kernel']:.3f} hit_frac {float(ok_x.mean()):.4f} "
            f"hit_agree {agree:.6f} t_within_1e-3 {close:.6f}",
            flush=True,
        )
        check(both.sum() > 1000, f"{name}: too few hits to compare ({both.sum()})")
        check(agree >= 0.999, f"{name}: hit/miss agree on {agree:.6f} < 0.999")
        check(close >= 0.999, f"{name}: |dt| <= 1e-3 on {close:.6f} < 0.999")
        results[name] = secs
    return results


def camera_rays(n):
    """n pinhole rays (256 wide) of the terrain scene's camera: from
    (0, 6, -4) towards (0, 0, 10), 60 degree field of view."""
    eye = np.asarray([0.0, 6.0, -4.0], np.float32)
    fwd = np.asarray([0.0, -6.0, 14.0], np.float32)
    fwd /= np.linalg.norm(fwd)
    right = np.cross([0.0, 1.0, 0.0], fwd)
    right /= np.linalg.norm(right)
    up = np.cross(fwd, right)
    w, h = 256, n // 256
    xs = (np.arange(w) + 0.5) / w * 2.0 - 1.0
    ys = ((np.arange(h) + 0.5) / h * 2.0 - 1.0) * h / w
    gx, gy = np.meshgrid(xs, ys)
    tan = np.tan(np.radians(30.0))
    d = fwd[None] + (gx.reshape(-1, 1) * right[None] + gy.reshape(-1, 1) * up[None]) * tan
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return np.broadcast_to(eye, d.shape).astype(np.float32), d.astype(np.float32)


def phase_sweep(terrain_path):
    """The leaf-sweep kernel inside the wide-BVH traversal of the terrain's
    clusters, at the renderer's launch width, against the XLA sweep."""
    import jax
    import jax.numpy as jnp

    from pyrite_tpu import kernels, tracer
    from pyrite_tpu.project import load_project
    from pyrite_tpu.scene import build_scene

    scene = build_scene(load_project(terrain_path))
    n = tracer.CLUSTER_LANE_CAP
    o_np, d_np = camera_rays(n)
    o, d = jnp.asarray(o_np), jnp.asarray(d_np)
    data = scene.device_data()
    print(f"[sweep] lanes {n} leaf {scene.cluster_leaf} slots {scene.cluster_slots} "
          f"block {kernels.SWEEP_BLOCK} warps {kernels.SWEEP_WARPS}")

    def traverse(o, d, data, shadow):
        with scene.bind(data):
            if shadow:
                init = {"t": jnp.full(n, 12.0)}
                return tracer._cluster_traverse(
                    scene, o, d, init, tracer._cluster_leaf_shadow(scene)
                )
            init = {
                "t": jnp.full(n, jnp.inf), "kind": jnp.zeros(n, jnp.int32),
                "idx": jnp.zeros(n, jnp.int32), "u": jnp.zeros(n), "v": jnp.zeros(n),
            }
            return tracer._cluster_traverse(
                scene, o, d, init, tracer._cluster_leaf_closest(scene)
            )

    for query in ("closest", "shadow"):
        outs, secs = {}, {}
        for path in ("kernel", "xla"):
            with kernels.use_path(path):
                compiled = jax.jit(
                    lambda o, d, data: traverse(o, d, data, query == "shadow")
                ).lower(o, d, data).compile()
            print(f"[sweep] {query} {path} memory_analysis: {compiled.memory_analysis()}")
            secs[path] = median_time(compiled, (o, d, data))
            outs[path] = {k: np.asarray(v) for k, v in compiled(o, d, data).items()}
        tk, tx = outs["kernel"]["t"], outs["xla"]["t"]
        hit_k, hit_x = np.isfinite(tk) & (tk < 12.0), np.isfinite(tx) & (tx < 12.0)
        agree = float((hit_k == hit_x).mean())
        both = hit_k & hit_x
        close = float((np.abs(tk[both] - tx[both]) <= 1e-5 * np.abs(tx[both])).mean())
        same = 1.0
        if query == "closest":
            same = float((outs["kernel"]["idx"] == outs["xla"]["idx"])[both].mean())
        print(
            f"[sweep] {query}: kernel_s {secs['kernel']:.6f} xla_s {secs['xla']:.6f} "
            f"speedup {secs['xla'] / secs['kernel']:.3f} hit_frac {float(hit_x.mean()):.4f} "
            f"hit_agree {agree:.6f} t_rel_1e-5 {close:.6f} same_prim {same:.6f}",
            flush=True,
        )
        check(not np.isnan(tk).any(), f"sweep {query}: NaN t")
        check(both.sum() > 1000, f"sweep {query}: too few hits ({both.sum()})")
        check(agree >= 0.999 and close >= 0.999 and same >= 0.999,
              f"sweep {query}: kernel disagrees with the XLA sweep")


# ---- phases 3-6: renders through the CLI ------------------------------------


def phase_spheres(workdir, clock, samples):
    path = write_scene(workdir, "spheres.lua", spheres_scene())
    acc, wt, image, _ = run_cli("spheres", path, ["--samples", str(samples)], clock, workdir)
    # the emissive ball (centre of the frame, ~75 px radius) holds the
    # brightest 32x32 block
    h, w, _ = image.shape
    lum = image.astype(np.float64).mean(axis=2)
    blocks = lum[: h // 32 * 32, : w // 32 * 32].reshape(h // 32, 32, w // 32, 32).mean(axis=(1, 3))
    by, bx = np.unravel_index(np.argmax(blocks), blocks.shape)
    cy, cx = by * 32 + 16, bx * 32 + 16
    dist = float(np.hypot(cy - h / 2, cx - w / 2))
    print(f"[spheres] brightest block centre ({cx}, {cy}), {dist:.1f} px from frame centre")
    check(dist <= 60.0, "spheres: the brightest block is not on the emissive ball")
    # the same render again, same seed: is the film bitwise reproducible?
    acc2, wt2, _, _ = run_cli("spheres_again", path, ["--samples", str(samples)], clock, workdir)
    print(
        f"[spheres] same-seed rerun: max |d acc| {float(np.abs(acc - acc2).max()):.6g} "
        f"max |d wt| {float(np.abs(wt - wt2).max()):.6g}",
        flush=True,
    )


def phase_terrain(workdir, clock, samples, path):
    run_cli("terrain", path, ["--samples", str(samples)], clock, workdir)


def phase_cornell(workdir, clock, samples):
    """The same render through the march kernel and through the XLA march,
    same seed, in turns (kernel, xla, kernel, xla): the first of each pays
    its one-off costs, the second is the steady comparison."""
    from pyrite_tpu import kernels

    path = write_scene(workdir, "cornell.lua", cornell_scene())
    images, times = {}, {"kernel": [], "xla": []}
    for i, march in enumerate(("kernel", "xla", "kernel", "xla")):
        with kernels.use_path(march):
            _, _, image, t = run_cli(
                f"cornell_{march}_{i}", path, ["--samples", str(samples)], clock, workdir
            )
        images.setdefault(march, image)
        times[march].append(t["render_s"])
    diff = np.abs(images["kernel"].astype(np.float64) - images["xla"].astype(np.float64))
    print(
        f"[cornell] render_s kernel {times['kernel'][0]:.3f} then {times['kernel'][1]:.3f}, "
        f"xla {times['xla'][0]:.3f} then {times['xla'][1]:.3f}; steady speedup "
        f"{times['xla'][1] / times['kernel'][1]:.3f}; developed-image mean |diff| "
        f"{diff.mean():.4f} of 255",
        flush=True,
    )


def phase_photon(workdir, clock):
    path = write_scene(workdir, "photon.lua", photon_scene())
    run_cli("photon", path, ["--samples", "4"], clock, workdir)


def four_cards(workdir, clock):
    """--multi-device over 4 cards vs the same render on one card."""
    import jax

    check(len(jax.devices()) >= 4, f"--four-cards: {len(jax.devices())} devices")
    # the phase-3 scene without dispersion: a dispersive bounce discards the
    # auxiliary wavelengths, and then no weight sum is exact
    path = write_scene(workdir, "spheres.lua", spheres_scene(dispersion=0))
    samples = 6  # not a multiple of 4: one sample group masks devices off
    acc1, wt1, _, _ = run_cli("one_card", path, ["--samples", str(samples)], clock, workdir)
    acc4, wt4, _, _ = run_cli(
        "four_cards", path, ["--samples", str(samples), "--multi-device"], clock, workdir
    )
    from pyrite_tpu.project import load_project

    lambdas = load_project(path).project.renderer.spectrum_samples
    expected = samples * wt1.shape[0] * wt1.shape[1] * lambdas
    print(f"[four-cards] weight sum one card {float(wt1.sum())} four cards "
          f"{float(wt4.sum())} expected {expected}")
    check(float(wt1.sum()) == expected, "one card: weight != samples x pixels x lambda")
    check(float(wt4.sum()) == expected, "four cards: weight != samples x pixels x lambda")

    def develop(acc, wt):
        return np.where(wt > 0, acc / np.where(wt > 0, wt, 1.0), 0.0).mean(axis=2)

    single, sharded = develop(acc1, wt1), develop(acc4, wt4)
    lit = single > 0.05
    rel = np.abs(single - sharded)[lit] / single[lit]
    print(f"[four-cards] median relative difference over {int(lit.sum())} lit pixels "
          f"{float(np.median(rel)):.4f}")
    check(np.median(rel) < 0.2, "four cards: median relative difference >= 0.2")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--four-cards", action="store_true",
        help="run only the --multi-device render on 4 cards and its one-card comparison",
    )
    args = parser.parse_args(argv)

    devices = require_gpu()
    import jax

    from pyrite_tpu.compile_cache import enable_compile_cache

    dev = devices[0]
    print(f"platform {dev.platform} device_kind {dev.device_kind} "
          f"device_count {len(devices)} jax {jax.__version__}")
    print(f"card {card_line()}")
    print(f"compile cache {enable_compile_cache()}", flush=True)
    clock = CompileClock()

    started = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        if args.four_cards:
            four_cards(workdir, clock)
        else:
            terrain_path, tris = terrain_scene(workdir)
            print(f"[terrain] {tris} triangles")
            check(tris == 328050, f"terrain: {tris} triangles")
            phase_march()
            phase_sweep(terrain_path)
            phase_spheres(workdir, clock, samples=8)
            phase_terrain(workdir, clock, samples=4, path=terrain_path)
            phase_cornell(workdir, clock, samples=2)
            phase_photon(workdir, clock)
    print(f"total_s {time.perf_counter() - started:.3f}")
    print(f"card {card_line()}")
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(devices),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
