"""Command-line driver: ``python -m pyrite_tpu <project.lua>``.

Mirrors the reference binary (main.rs:52-109): loads the Lua project, renders
with periodic preview writes (every >= 20 s, main.rs:261-299), and writes the
final development to ``<project_dir>/render.png``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import jax
import numpy as np

from .compile_cache import enable_compile_cache
from .png import write_png
from .project import load_project
from .scene import build_scene


def make_develop_sample_fn(project_data, scene, span):
    """The image ``filter``/``white`` post-process (main.rs:197-238).

    Returns a callable (values [.., T], wavelengths [T]) -> values, or None.
    """
    import jax.numpy as jnp

    from . import spectra as spectra_mod
    from .exprs import ProgramInputs, compile_program, NUMBER

    image = project_data.project.image
    if image.filter is None and image.white is None:
        return None

    resources = scene.resources
    filter_prog = (
        compile_program(image.filter, resources, NUMBER)
        if image.filter is not None
        else None
    )
    white_prog = (
        compile_program(image.white, resources, NUMBER)
        if image.white is not None
        else None
    )

    white_max = None
    d65_max = None
    if white_prog is not None:
        lo, hi = span
        wl_grid = np.arange(lo, hi, 1.0, np.float32)
        vals = np.asarray(white_prog(ProgramInputs(wavelength=jnp.asarray(wl_grid))))
        white_max = float(np.max(np.broadcast_to(vals, wl_grid.shape)))
        d65_max = float(np.max(spectra_mod.d65().sample_np(wl_grid)))

    def sample_fn(values, wavelengths):
        inputs = ProgramInputs(wavelength=wavelengths)
        if filter_prog is not None:
            values = values * jnp.broadcast_to(
                filter_prog(inputs), wavelengths.shape
            )
        if white_prog is not None:
            white_intensity = (
                jnp.broadcast_to(white_prog(inputs), wavelengths.shape) / white_max
            )
            neutral = values / jnp.maximum(white_intensity, 1e-6)
            values = neutral * (spectra_mod.d65().sample(wavelengths) / d65_max)
        return values

    return sample_fn


def _run_render(args, algorithm_mod, project_data, scene, on_progress, resume):
    if args.multi_device and len(jax.devices()) > 1:
        from .parallel import make_mesh

        return algorithm_mod.render_sharded(
            project_data,
            scene,
            make_mesh(),
            seed=args.seed,
            on_progress=on_progress,
            max_samples=args.samples,
            resume=resume,
        )
    return algorithm_mod.render(
        project_data,
        scene,
        seed=args.seed,
        on_progress=on_progress,
        max_samples=args.samples,
        resume=resume,
    )


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="pyrite-tpu", description="spectral path tracer (JAX)"
    )
    parser.add_argument("project", help="path to a .lua project file")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--samples", type=int, default=None, help="override pixel_samples"
    )
    parser.add_argument(
        "--output", default=None, help="output PNG path (default: <project>/render.png)"
    )
    parser.add_argument(
        "--preview-interval", type=float, default=20.0, help="seconds between previews"
    )
    parser.add_argument(
        "--multi-device",
        action="store_true",
        help="shard samples across all visible devices",
    )
    parser.add_argument(
        "--checkpoint",
        default=None,
        help="film checkpoint path (.npz): resumed from if present, written "
        "at every preview interval and at the end (the reference loses all "
        "accumulation on a crash; this does not)",
    )
    parser.add_argument(
        "--profile",
        default=None,
        metavar="DIR",
        help="write a JAX profiler trace of the render phase to DIR "
        "(viewable with TensorBoard / Perfetto; the reference has no "
        "profiler hooks, SURVEY.md section 5)",
    )
    args = parser.parse_args(argv)
    enable_compile_cache()

    loading_started = time.time()
    from .lua.interpreter import LuaError
    from .project.ir import ProjectError

    loading_errors = (OSError, LuaError, ProjectError, SyntaxError, ValueError, KeyError)
    try:
        project_data = load_project(args.project)
        scene = build_scene(project_data)
    except loading_errors as error:
        # the reference reports load errors stringly and exits non-zero
        # (main.rs:68-71); unexpected exception types propagate with a real
        # traceback instead of being swallowed
        print(f"error while loading project file: {error}", file=sys.stderr)
        return 1
    loading_ended = time.time()

    settings = project_data.project.renderer
    algorithm = settings.algorithm
    render_path = args.output or os.path.join(
        os.path.dirname(os.path.abspath(args.project)), "render.png"
    )
    span = settings.spectrum_span
    sample_fn = make_develop_sample_fn(project_data, scene, span)

    if algorithm == "simple":
        from .renderers import simple as algorithm_mod
    elif algorithm == "bidirectional":
        from .renderers import bidirectional as algorithm_mod
    elif algorithm == "photon_mapping":
        from .renderers import photon as algorithm_mod
    else:
        print(f"unknown renderer: {algorithm}", file=sys.stderr)
        return 1

    state = {"last_preview": time.time()}

    def write_checkpoint(acc, wt, samples_done):
        np.savez(
            args.checkpoint,
            acc=np.asarray(acc),
            wt=np.asarray(wt),
            samples_done=samples_done,
        )

    resume = None
    if args.checkpoint and os.path.exists(args.checkpoint):
        loaded = np.load(args.checkpoint)
        resume = {
            "acc": loaded["acc"],
            "wt": loaded["wt"],
            "samples_done": int(loaded["samples_done"]),
        }
        print(f"Resuming from {args.checkpoint} ({resume['samples_done']} samples done)")

    def on_progress(progress):
        pct = progress.sample * 100 // progress.total
        print(f"\rRendering: {pct:3d}% ({progress.sample}/{progress.total})", end="")
        now = time.time()
        if now - state["last_preview"] >= args.preview_interval:
            img = progress.film.to_image(progress.acc, progress.wt, 30.0, sample_fn)
            write_png(render_path, img)
            if args.checkpoint:
                write_checkpoint(progress.acc, progress.wt, progress.sample)
            print(f"  [preview written to {render_path}]")
            state["last_preview"] = now

    rendering_started = time.time()
    import contextlib

    profile_ctx = (
        jax.profiler.trace(args.profile)
        if args.profile
        else contextlib.nullcontext()
    )
    with profile_ctx:
        film, acc, wt = _run_render(
            args, algorithm_mod, project_data, scene, on_progress, resume
        )
    jax.block_until_ready((acc, wt))
    rendering_ended = time.time()
    if args.profile:
        print(f"\nProfiler trace written to {args.profile}")
    samples = args.samples or settings.pixel_samples
    if args.checkpoint:
        write_checkpoint(acc, wt, samples)
    lanes = project_data.project.image.width * project_data.project.image.height
    rays = lanes * samples * settings.bounces * (1 + settings.light_samples)
    elapsed = rendering_ended - rendering_started
    print(
        f"\nThroughput: {rays / max(elapsed, 1e-9) / 1e6:.1f} Mrays/s "
        f"({samples / max(elapsed, 1e-9):.2f} spp/s), wall {elapsed:.1f}s"
    )

    print("\nSaving final result...")
    img = film.to_image(acc, wt, 2.0, sample_fn)
    write_png(render_path, img)

    print("Done.")
    print(f"Project loading: {loading_ended - loading_started:.2f}s")
    print(f"Rendering: {rendering_ended - rendering_started:.2f}s")
    print(f"Total: {rendering_ended - loading_started:.2f}s")
    print(f"Output: {render_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
