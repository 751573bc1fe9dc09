"""The GPU smoke check's CPU-side contract and the compile-cache helper."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from pyrite_tpu import compile_cache  # noqa: E402


def test_smoke_refuses_the_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT,
    )
    assert out.returncode != 0
    assert "needs a GPU" in out.stderr
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize(
    "make",
    [
        lambda d: chip_smoke.spheres_scene(w=16, h=8),
        lambda d: chip_smoke.spheres_scene(w=16, h=8, dispersion=0),
        lambda d: chip_smoke.cornell_scene(w=8, h=8),
        lambda d: chip_smoke.photon_scene(w=8, h=8),
        lambda d: chip_smoke.terrain_scene(d, w=8, h=4, cells=4)[0],
    ],
    ids=["spheres", "spheres_no_dispersion", "cornell", "photon", "terrain"],
)
def test_smoke_scenes_parse(make, tmp_path):
    from pyrite_tpu.project import load_project

    src = make(str(tmp_path))
    if src.endswith(".lua"):
        path = src
    else:
        path = str(tmp_path / "scene.lua")
        with open(path, "w") as fh:
            fh.write(src)
    project = load_project(path).project
    assert project.image.width <= 16 and project.world.objects


def test_cornell_smoke_scene_builds_its_fractal(tmp_path):
    from pyrite_tpu.project import load_project
    from pyrite_tpu.scene import build_scene

    path = tmp_path / "cornell.lua"
    path.write_text(chip_smoke.cornell_scene(w=8, h=8))
    scene = build_scene(load_project(str(path)))
    (shape,) = scene.de_shapes
    assert shape.estimator["variant"] == "cubic"
    assert shape.estimator["iterations"] == 25


def test_compile_cache_honours_the_environment(monkeypatch):
    updates = []
    monkeypatch.setattr(compile_cache.jax.config, "update", lambda *a: updates.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    monkeypatch.setattr(compile_cache.jax, "default_backend", lambda: "gpu")
    assert compile_cache.enable_compile_cache() == "/elsewhere/cache"
    assert updates == []  # JAX reads the variable itself


def test_compile_cache_fixed_path_and_cpu(monkeypatch):
    updates = []
    monkeypatch.setattr(compile_cache.jax.config, "update", lambda *a: updates.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    # CPU runs (the tests) keep no cache
    assert compile_cache.enable_compile_cache() is None
    assert updates == []
    monkeypatch.setattr(compile_cache.jax, "default_backend", lambda: "gpu")
    fixed = os.path.join(ROOT, ".jax_cache")
    assert compile_cache.CACHE_DIR == fixed
    assert compile_cache.enable_compile_cache() == fixed
    assert updates == [("jax_compilation_cache_dir", fixed)]
