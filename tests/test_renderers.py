"""Cross-algorithm consistency tests on a shared scene (CPU)."""

import numpy as np
import pytest

from pyrite_tpu.project import load_project
from pyrite_tpu.scene import build_scene


SCENE = """
return {
    image = {width = 20, height = 20},
    camera = camera.perspective {
        fov = 60,
        transform = transform.look_at {from = vector(0, 2, 6), to = vector(0, 1, 0)},
    },
    renderer = renderer.%(algo)s {
        pixel_samples = %(spp)d, spectrum_samples = 4, bounces = 4,
        light_samples = 2%(extra)s
    },
    world = {
        objects = {
            shape.sphere {
                radius = 50, position = vector(0, -50, 0),
                material = {surface = material.diffuse {color = 0.7}},
            },
            shape.sphere {
                radius = 1, position = vector(0, 3, 0),
                material = {surface = material.emissive {color = 2}},
            },
            shape.sphere {
                radius = 0.8, position = vector(1.5, 0.8, 0),
                material = {surface = material.diffuse {color = 0.4}},
            },
        },
    },
}
"""


def render(tmp_path, algo, spp, extra=""):
    src = SCENE % {"algo": algo, "spp": spp, "extra": extra}
    path = tmp_path / f"{algo}.lua"
    path.write_text(src)
    pd = load_project(str(path))
    scene = build_scene(pd)
    if algo == "simple":
        from pyrite_tpu.renderers import simple as mod
    elif algo == "bidirectional":
        from pyrite_tpu.renderers import bidirectional as mod
    else:
        from pyrite_tpu.renderers import photon as mod
    film, acc, wt = mod.render(pd, scene, seed=3, max_samples=spp)
    return np.asarray(film.develop(acc, wt)).mean(axis=2)


def test_bdpt_camera_side_matches_simple(tmp_path, monkeypatch):
    """With splats and connections contributing their own weighted samples,
    the estimators differ per-pixel at low spp; but the BDPT camera-side
    transport must match the simple renderer when the extra techniques are
    disabled."""
    from pyrite_tpu.renderers import bidirectional as bd

    simple_img = render(tmp_path, "simple", 250)
    monkeypatch.setattr(
        bd, "_light_splats",
        lambda scene, film, camera, cfg, conn, wl, acc, wt: (acc, wt),
    )
    bdpt_img = render(tmp_path, "bidirectional", 250, extra=", light_bounces = 4")
    lit = simple_img > 0.02
    rel = np.abs(simple_img - bdpt_img)[lit] / simple_img[lit]
    assert np.median(rel) < 0.25


def test_bdpt_runs_and_produces_light(tmp_path):
    img = render(tmp_path, "bidirectional", 24, extra=", light_bounces = 4")
    assert img.max() > 0.05
    assert np.isfinite(img).all()


def test_bdpt_compacted_connections_match_full(tmp_path):
    """The two-phase path (compact connectable lamp slots to [N, K'] before
    the camera walk) must reproduce the fused full-capacity step — same
    PRNG draws, same connections, only the slot layout differs."""
    import jax

    from pyrite_tpu.film import Film
    from pyrite_tpu.renderers import bidirectional as bd
    from pyrite_tpu.scene import CameraModel
    from pyrite_tpu.tracer import TraceConfig

    src = SCENE % {"algo": "bidirectional", "spp": 4,
                   "extra": ", light_bounces = 24"}
    path = tmp_path / "deep.lua"
    path.write_text(src)
    pd = load_project(str(path))
    scene = build_scene(pd)
    project = pd.project
    film = Film(width=project.image.width, height=project.image.height,
                bins=project.renderer.spectrum_bins,
                span=project.renderer.spectrum_span)
    camera = CameraModel.from_ir(project.camera)
    cfg = TraceConfig(bounces=4, light_samples=2, spectrum_samples=4)

    fused = bd.make_render_step(scene, film, camera, cfg, 24, film.height)
    lamp_step, compact_step, cam_step = bd.make_render_step(
        scene, film, camera, cfg, 24, film.height, two_phase=True
    )

    data = scene.device_data()
    key = jax.random.PRNGKey(7)
    acc0, wt0 = film.new_buffers()
    acc_a, wt_a = fused(acc0, wt0, key, data)

    conn, count = lamp_step(key, data)
    assert int(count) < 25  # deep budget, short actual paths
    k_new = max(4, int(count))
    conn_c = compact_step(conn, k_new)
    acc0, wt0 = film.new_buffers()
    acc_b, wt_b = cam_step(acc0, wt0, key, data, conn_c)

    np.testing.assert_allclose(
        np.asarray(acc_a), np.asarray(acc_b), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(wt_a), np.asarray(wt_b), rtol=1e-4, atol=1e-5
    )


def test_compaction_ladder_matches_flat(tmp_path, monkeypatch):
    """trace_paths' compaction ladder (head bounces full-width, survivors
    compacted into 1/DIV-width chunks with early exit) must preserve the
    estimator: same total film weight, statistically matching radiance.
    Lane permutation changes per-lane PRNG draws, so images agree
    statistically, not bitwise."""
    import pyrite_tpu.tracer as tracer_mod
    from pyrite_tpu.film import Film
    from pyrite_tpu.renderers import simple as simple_mod

    src = SCENE % {"algo": "simple", "spp": 150, "extra": ""}
    path = tmp_path / "ladder.lua"
    path.write_text(src)
    pd = load_project(str(path))
    scene = build_scene(pd)
    # the ladder lives in trace_paths (one-shot path); pin the scheduler
    monkeypatch.setattr(simple_mod, "regen_enabled", lambda: False)

    def img_and_wt():
        film, acc, wt = simple_mod.render(pd, scene, seed=7, max_samples=150)
        return np.asarray(film.develop(acc, wt)).mean(axis=2), float(np.asarray(wt).sum())

    flat_img, flat_wt = img_and_wt()
    monkeypatch.setattr(tracer_mod, "LADDER_MIN_LANES", 1)
    monkeypatch.setattr(tracer_mod, "LADDER_DIV", 4)
    ladder_img, ladder_wt = img_and_wt()

    assert ladder_wt == flat_wt  # every lane exposed exactly once
    lit = flat_img > 0.05
    assert lit.sum() > 40
    rel = np.abs(flat_img - ladder_img)[lit] / flat_img[lit]
    assert np.median(rel) < 0.15, f"median rel {np.median(rel):.3f}"
    ratio = ladder_img[lit].mean() / flat_img[lit].mean()
    assert 0.9 < ratio < 1.1, f"ratio {ratio:.3f}"


def test_photon_partialR_grid_interpolation_error(tmp_path):
    """Bound the one remaining photon-map spectral deviation (photon.py
    module docstring): chain reflectance at arbitrary pair wavelengths is
    linearly interpolated from a dense lambda grid instead of re-walking the
    programs per pair (the reference re-evaluates exactly,
    photon_mapping.rs:447-494). On a scene with a wiggly measured-style
    spectrum, grid interpolation must agree with exact re-evaluation (same
    paths traced with probe wavelengths appended) within a small bound."""
    import jax
    import jax.numpy as jnp
    from pyrite_tpu.film import Film
    from pyrite_tpu.scene import CameraModel
    from pyrite_tpu.tracer import TraceConfig
    from pyrite_tpu.renderers import photon as ph
    from pyrite_tpu.renderers.simple import chunk_rays

    src = SCENE % {"algo": "photon_mapping", "spp": 4, "extra": ""}
    src = src.replace(
        "material.diffuse {color = 0.7}",
        "material.diffuse {color = spectrum {format = \"array\", min = 400,"
        " max = 700, points = {0.2, 0.9, 0.3, 0.8, 0.25, 0.7, 0.4}}}",
    )
    path = tmp_path / "interp.lua"
    path.write_text(src)
    pd = load_project(str(path))
    scene = build_scene(pd)
    project = pd.project
    film = Film(width=project.image.width, height=project.image.height,
                bins=project.renderer.spectrum_bins,
                span=project.renderer.spectrum_span)
    camera = CameraModel.from_ir(project.camera)
    cfg = TraceConfig(bounces=4, light_samples=0, spectrum_samples=4)
    lo, hi = film.span
    g_bins = 64
    grid = jnp.asarray([lo + (i + 0.5) * (hi - lo) / g_bins for i in range(g_bins)])
    probes = jnp.linspace(lo + 10.0, hi - 10.0, 7)

    key = jax.random.PRNGKey(5)
    data = scene.device_data()
    with scene.bind(data):
        positions, origin, direction, wavelengths = chunk_rays(film, camera, cfg, key)
        n = origin.shape[0]
        kt = jax.random.fold_in(key, 3)
        wl_g = jnp.concatenate(
            [wavelengths, jnp.broadcast_to(grid[None, :], (n, g_bins))], axis=1
        )
        wl_p = jnp.concatenate(
            [wavelengths, jnp.broadcast_to(probes[None, :], (n, 7))], axis=1
        )
        # identical keys -> identical paths: sampling decisions depend only on
        # column 0 and the per-bounce PRNG stream, never on the extra columns
        _, rec_g = ph._record_camera_vertices(scene, cfg, kt, origin, direction, wl_g)
        _, rec_p = ph._record_camera_vertices(scene, cfg, kt, origin, direction, wl_p)

    s = cfg.spectrum_samples
    errs = []
    for b in range(cfg.bounces):
        valid = np.asarray(rec_g["valid"][:, b])
        if not valid.any():
            continue
        exact = np.asarray(rec_p["partialR"][:, b, s:])[valid]  # [V, 7]
        approx = np.asarray(
            ph.interp_cols(
                rec_g["partialR"][:, b, s:],
                film.span,
                jnp.broadcast_to(probes[None, :], (n, 7)),
            )
        )[valid]
        big = exact > 1e-3
        if big.any():
            errs.append(np.abs(approx - exact)[big] / exact[big])
    rel = np.concatenate(errs)
    # measured at the default 64-point grid on the CPU: p95 ~1e-7, max
    # ~0.53% (each grid-density halving costs ~4x, and photon.render's memory budget
    # keeps 64 points up to 1024x512 films)
    assert np.percentile(rel, 95) < 0.005, f"p95 interp err {np.percentile(rel, 95):.4f}"
    assert rel.max() < 0.01, f"max interp err {rel.max():.4f}"


def test_photon_exact_chain_reeval_matches_traced_columns(tmp_path):
    """Lambda-only scenes re-walk chains EXACTLY at pair wavelengths from
    per-vertex color-program count vectors + scalar prefixes (photon.py
    exact_chain_mode; the reference's per-pair chain re-evaluation,
    photon_mapping.rs:340-426). The reconstruction at a probe wavelength
    must match the chain value obtained by tracing with that wavelength as
    an extra column — for both the camera-side partialR and photon powers."""
    import jax
    import jax.numpy as jnp
    from pyrite_tpu.film import Film
    from pyrite_tpu.scene import CameraModel
    from pyrite_tpu.tracer import TraceConfig, trace_lamp_path
    from pyrite_tpu.renderers import photon as ph
    from pyrite_tpu.renderers.bidirectional import _lamp_path_factors
    from pyrite_tpu.renderers.simple import chunk_rays

    src = SCENE % {"algo": "photon_mapping", "spp": 4, "extra": ""}
    src = src.replace(
        "material.diffuse {color = 0.7}",
        "material.diffuse {color = spectrum {format = \"array\", min = 400,"
        " max = 700, points = {0.2, 0.9, 0.3, 0.8, 0.25, 0.7, 0.4}}}",
    )
    path = tmp_path / "exact.lua"
    path.write_text(src)
    pd = load_project(str(path))
    scene = build_scene(pd)
    assert ph.exact_chain_mode(scene), "scene should be lambda-only"
    m_count = len(scene.color_programs)

    project = pd.project
    film = Film(width=project.image.width, height=project.image.height,
                bins=project.renderer.spectrum_bins,
                span=project.renderer.spectrum_span)
    camera = CameraModel.from_ir(project.camera)
    cfg = TraceConfig(bounces=4, light_samples=0, spectrum_samples=4)
    lo, hi = film.span
    probes = jnp.linspace(lo + 10.0, hi - 10.0, 7)

    key = jax.random.PRNGKey(5)
    data = scene.device_data()
    with scene.bind(data):
        positions, origin, direction, wavelengths = chunk_rays(film, camera, cfg, key)
        n = origin.shape[0]
        kt = jax.random.fold_in(key, 3)
        wl_p = jnp.concatenate(
            [wavelengths, jnp.broadcast_to(probes[None, :], (n, 7))], axis=1
        )
        # same keys -> same paths; the probe columns carry ground truth
        _, rec = ph._record_camera_vertices(
            scene, cfg, kt, origin, direction, wl_p, chain_m=m_count
        )
        logF, negF = ph._log_factors(
            scene, jnp.broadcast_to(probes[None, :], (n, 7))
        )

        # photon side: trace a lamp path with probe columns, reconstruct
        # parent-chain powers at the probes from counts + scalars
        kl = jax.random.fold_in(key, 9)
        lam_rep = jnp.broadcast_to(probes[None, :], (64, 7))
        lpath = trace_lamp_path(scene, TraceConfig(
            bounces=3, light_samples=0, spectrum_samples=1
        ), kl, lam_rep)
        pp, _, _, _ = _lamp_path_factors(scene, lpath, lam_rep, cfg)
        pp_parent = jnp.concatenate(
            [jnp.ones_like(pp[:, :1]), pp[:, :-1]], axis=1
        )
        power_truth = lpath["probability"][:, :, None] * pp_parent
        counts_parent, ps_parent = ph._lamp_chain_counts(scene, lpath, m_count)
        p_scalar = lpath["probability"] * ps_parent
        logF_l, negF_l = ph._log_factors(scene, lam_rep)

    s = cfg.spectrum_samples
    errs = []
    for b in range(cfg.bounces):
        valid = np.asarray(rec["valid"][:, b]) & ~np.asarray(rec["dispersed"][:, b])
        if not valid.any():
            continue
        truth = np.asarray(rec["partialR"][:, b, s:])[valid]  # [V, 7]
        recon = np.asarray(ph._chain_eval(
            rec["counts"][:, b][:, None, :], rec["scalar"][:, b][:, None],
            logF, negF,
        ))[valid]
        big = truth > 1e-4
        if big.any():
            errs.append(np.abs(recon - truth)[big] / truth[big])
    rel = np.concatenate(errs)
    assert rel.max() < 1e-4, f"camera chain re-eval max err {rel.max():.2e}"

    slots = np.asarray(lpath["valid"]).shape[1]
    perrs = []
    for t in range(slots):
        valid = np.asarray(lpath["valid"][:, t])
        if not valid.any():
            continue
        truth = np.asarray(power_truth[:, t])[valid]  # [V, 7]
        recon = np.asarray(ph._chain_eval(
            counts_parent[:, t][:, None, :], p_scalar[:, t][:, None],
            logF_l, negF_l,
        ))[valid]
        big = truth > 1e-4
        if big.any():
            perrs.append(np.abs(recon - truth)[big] / truth[big])
    prel = np.concatenate(perrs)
    assert prel.max() < 1e-4, f"photon chain re-eval max err {prel.max():.2e}"


def test_photon_mapping_runs_and_produces_light(tmp_path):
    img = render(
        tmp_path,
        "photon_mapping",
        4,
        extra=", photons = 1500, photon_bounces = 4, radius = 0.4",
    )
    assert img.max() > 0.01
    assert np.isfinite(img).all()
    # the emissive ball must be directly visible
    assert img[:8].max() > 0.1


def test_cluster_path_matches_dense_without_native(tmp_path, monkeypatch):
    """With the native builder unavailable and the cluster threshold lowered,
    the numpy clustered-BVH path must render the same image as the dense
    sweep. Hits agree on prim identity everywhere; t can differ by ULPs
    (XLA fuses the two paths differently), which at low spp can flip an
    occasional occlusion test — so a handful of pixels may diverge."""
    import pyrite_tpu.scene as scene_mod
    import pyrite_tpu.tracer as tracer_mod
    from pyrite_tpu import native

    # both paths must consume identical RNG streams; the dense path would
    # otherwise take the multi-sample megabatch or the regen scheduler
    # (different trace keys)
    monkeypatch.setenv("PYRITE_TPU_SAMPLE_BATCH", "1")
    monkeypatch.setenv("PYRITE_TPU_REGEN", "0")
    dense_img = render(tmp_path, "simple", 8)

    monkeypatch.setattr(native, "build_bvh_clustered", lambda *a, **k: None)
    monkeypatch.setattr(scene_mod, "CLUSTER_THRESHOLD", 1)
    monkeypatch.setattr(tracer_mod, "BRUTE_FORCE_PRIMS", 1)
    cluster_img = render(tmp_path, "simple", 8)

    close = np.isclose(cluster_img, dense_img, rtol=1e-4, atol=1e-6)
    assert close.mean() > 0.99, f"{(~close).sum()} of {close.size} pixels diverge"
    np.testing.assert_allclose(cluster_img.mean(), dense_img.mean(), rtol=1e-3)


def test_hash_grid_gather_matches_brute_force():
    """The sorted hash-grid 27-cell scan must enumerate exactly the photons
    within the gather radius (vs an O(N*P) brute-force query), as long as no
    cell exceeds the per-cell cap. Replaces the reference kd-tree radius
    query (spatial/kd_tree.rs:47-106; used at photon_mapping.rs:349)."""
    import jax
    import jax.numpy as jnp
    from pyrite_tpu.renderers import photon as ph

    rng = np.random.default_rng(17)
    P, N, radius = 500, 128, 0.35
    p_pos = jnp.asarray(rng.uniform(-3, 3, (P, 3)), jnp.float32)
    p_valid = jnp.asarray(rng.random(P) > 0.2)
    q_pos = jnp.asarray(rng.uniform(-3, 3, (N, 3)), jnp.float32)
    values = jnp.asarray(rng.random(P), jnp.float32)

    order, sorted_keys, starts, ckeys = ph.grid_prepare(p_pos, p_valid, q_pos, radius)

    def body(k, carry):
        total, count = carry
        pj, match = ph.grid_scan_slot(
            k, order, sorted_keys, starts, ckeys, p_valid, p_pos, q_pos, radius
        )
        total = total + jnp.where(match, values[pj], 0.0)
        count = count + match.astype(jnp.int32)
        return total, count

    total, count = jax.lax.fori_loop(
        0, 27 * ph._CELL_CAP, body, (jnp.zeros(N), jnp.zeros(N, jnp.int32))
    )

    d2 = ((np.asarray(p_pos)[None] - np.asarray(q_pos)[:, None]) ** 2).sum(-1)
    in_r = (d2 <= radius * radius) & np.asarray(p_valid)[None]
    # precondition for exactness: no cell over the scan cap
    cells = np.floor(np.asarray(p_pos)[np.asarray(p_valid)] / radius).astype(int)
    _, cell_counts = np.unique(cells, axis=0, return_counts=True)
    assert cell_counts.max() <= ph._CELL_CAP

    np.testing.assert_array_equal(np.asarray(count), in_r.sum(1))
    expect = (np.asarray(values)[None] * in_r).sum(1)
    np.testing.assert_allclose(np.asarray(total), expect, rtol=1e-5)


def test_photon_mapping_tracks_simple_radiance(tmp_path):
    """On the diffuse-only scene, the photon mapper must track the simple
    renderer's radiance (estimator weights photon_mapping.rs:47-48,369).

    Tolerances are wide by design: the reference's gather is a
    neighbor-averaging RATIO estimator — every pair exposes a film sample at
    the dispersal-selected wavelength (usually the photon's own random
    lambda) with weight photon_probability/num_neighbors, so a film bin that
    has collected few tempering camera/darkness weights reads close to the
    raw pair brightness. Per-bin values are therefore high-variance until
    many pixel samples land in every bin (measured: median |rel| 5.3 / 1.6 /
    0.8 at 10/40/120 spp, mean ratio drifting 1.40 -> 1.13). The test pins
    the mean brightness ratio inside a band and the per-pixel median inside
    the measured variance envelope at 40 spp — a scale bug (missing
    probability factor, double-counted weight) moves the ratio far outside
    the band."""
    simple_img = render(tmp_path, "simple", 200)
    photon_img = render(
        tmp_path,
        "photon_mapping",
        40,
        extra=", photons = 4000, photon_bounces = 5, photon_passes = 2, radius = 0.25",
    )
    lit = simple_img > 0.05
    assert lit.sum() > 40
    rel = np.abs(simple_img - photon_img)[lit] / simple_img[lit]
    assert np.median(rel) < 2.5, f"median rel err {np.median(rel):.3f}"
    ratio = photon_img[lit].mean() / simple_img[lit].mean()
    assert 0.6 < ratio < 2.0, f"brightness ratio {ratio:.3f}"


def test_pooled_scheduler_matches_one_shot(tmp_path, monkeypatch):
    """Deep-bounce scenes use the survivor-pool scheduler (simple.py): dead
    lanes expose at stage end, survivors are stream-compacted into a pool
    that continues across chunks/samples. Every lane must be exposed exactly
    once — total film weight is conserved exactly — and the radiance must
    statistically match the one-shot wavefront."""
    from pyrite_tpu.renderers import simple as simple_mod
    from pyrite_tpu.film import Film
    from pyrite_tpu.project import load_project
    from pyrite_tpu.scene import build_scene

    src = SCENE % {"algo": "simple", "spp": 48, "extra": ""}
    src = src.replace("bounces = 4", "bounces = 20")
    path = tmp_path / "pooled.lua"
    path.write_text(src)

    pd = load_project(str(path))
    scene = build_scene(pd)
    assert pd.project.renderer.bounces >= simple_mod.POOL_MIN_BOUNCES
    # pin the schedulers under comparison (regen would otherwise take both)
    monkeypatch.setattr(simple_mod, "regen_enabled", lambda: False)

    film, acc_p, wt_p = simple_mod.render(pd, scene, seed=3, max_samples=48)

    monkeypatch.setattr(simple_mod, "POOL_MIN_BOUNCES", 10_000)
    film, acc_o, wt_o = simple_mod.render(pd, scene, seed=3, max_samples=48)

    # exact invariant: every lane-sample exposed exactly once in both paths
    # (no dispersive materials here, so every wavelength column has weight)
    s = pd.project.renderer.spectrum_samples
    expect_wt = 48 * film.width * film.height * s
    np.testing.assert_allclose(float(np.asarray(wt_p).sum()), expect_wt, rtol=1e-6)
    np.testing.assert_allclose(float(np.asarray(wt_o).sum()), expect_wt, rtol=1e-6)

    img_p = np.asarray(film.develop(acc_p, wt_p)).mean(axis=2)
    img_o = np.asarray(film.develop(acc_o, wt_o)).mean(axis=2)
    lit = img_o > 0.02
    rel = np.abs(img_p - img_o)[lit] / img_o[lit]
    assert np.median(rel) < 0.15, f"median rel {np.median(rel):.3f}"
    np.testing.assert_allclose(img_p[lit].mean(), img_o[lit].mean(), rtol=0.05)


def test_regen_scheduler_matches_one_shot(tmp_path, monkeypatch):
    """The path-regeneration scheduler (simple.py:make_regen_step) restarts a
    fresh stratified sample on a lane the moment its path dies. The estimator
    must be the one-shot wavefront's: exact sample counts (film weight
    conserved bit-exactly) and statistically matching radiance. Reference
    semantics: renderer/simple.rs:23-73 (a tile thread likewise begins the
    next sample immediately after one finishes)."""
    from pyrite_tpu.renderers import simple as simple_mod

    src = SCENE % {"algo": "simple", "spp": 50, "extra": ""}
    path = tmp_path / "regen.lua"
    path.write_text(src)
    pd = load_project(str(path))
    scene = build_scene(pd)
    assert not scene.use_clusters

    monkeypatch.setattr(simple_mod, "regen_enabled", lambda: True)
    film, acc_r, wt_r = simple_mod.render(pd, scene, seed=5, max_samples=50)
    # determinism: same seed -> identical film
    film, acc_r2, wt_r2 = simple_mod.render(pd, scene, seed=5, max_samples=50)
    np.testing.assert_array_equal(np.asarray(acc_r), np.asarray(acc_r2))

    monkeypatch.setattr(simple_mod, "regen_enabled", lambda: False)
    film, acc_o, wt_o = simple_mod.render(pd, scene, seed=5, max_samples=50)

    s = pd.project.renderer.spectrum_samples
    expect_wt = 50 * film.width * film.height * s
    np.testing.assert_allclose(float(np.asarray(wt_r).sum()), expect_wt, rtol=1e-6)
    np.testing.assert_allclose(float(np.asarray(wt_o).sum()), expect_wt, rtol=1e-6)

    img_r = np.asarray(film.develop(acc_r, wt_r)).mean(axis=2)
    img_o = np.asarray(film.develop(acc_o, wt_o)).mean(axis=2)
    lit = img_o > 0.02
    rel = np.abs(img_r - img_o)[lit] / img_o[lit]
    assert np.median(rel) < 0.15, f"median rel {np.median(rel):.3f}"
    np.testing.assert_allclose(img_r[lit].mean(), img_o[lit].mean(), rtol=0.05)


def test_regen_deep_bounces_matches_pool(tmp_path, monkeypatch):
    """Deep budgets (>= POOL_MIN_BOUNCES) also ride regeneration on dense
    scenes; per-path depth counters must enforce the same bounce budget the
    one-shot loop's iteration count does."""
    from pyrite_tpu.renderers import simple as simple_mod

    src = SCENE % {"algo": "simple", "spp": 40, "extra": ""}
    src = src.replace("bounces = 4", "bounces = 20")
    path = tmp_path / "regen_deep.lua"
    path.write_text(src)
    pd = load_project(str(path))
    scene = build_scene(pd)

    monkeypatch.setattr(simple_mod, "regen_enabled", lambda: True)
    film, acc_r, wt_r = simple_mod.render(pd, scene, seed=9, max_samples=40)

    monkeypatch.setattr(simple_mod, "regen_enabled", lambda: False)
    monkeypatch.setattr(simple_mod, "POOL_MIN_BOUNCES", 10_000)
    film, acc_o, wt_o = simple_mod.render(pd, scene, seed=9, max_samples=40)

    s = pd.project.renderer.spectrum_samples
    expect_wt = 40 * film.width * film.height * s
    np.testing.assert_allclose(float(np.asarray(wt_r).sum()), expect_wt, rtol=1e-6)

    img_r = np.asarray(film.develop(acc_r, wt_r)).mean(axis=2)
    img_o = np.asarray(film.develop(acc_o, wt_o)).mean(axis=2)
    lit = img_o > 0.02
    rel = np.abs(img_r - img_o)[lit] / img_o[lit]
    assert np.median(rel) < 0.15, f"median rel {np.median(rel):.3f}"
    np.testing.assert_allclose(img_r[lit].mean(), img_o[lit].mean(), rtol=0.05)


def test_regen_scheduler_on_cluster_scene(tmp_path, monkeypatch):
    """Cluster (wide-BVH) scenes can opt into path regeneration
    (PYRITE_TPU_REGEN_CLUSTERS, simple.regen_clusters_enabled): exact sample
    counts and one-shot-matching radiance on a >1024-prim mesh scene."""
    import sys

    sys.path.insert(0, "/root/repo")
    from tools.synthetic import terrain_scene

    from pyrite_tpu.renderers import simple as simple_mod

    lua, tris = terrain_scene(str(tmp_path), cells=24, width=24, height=12, spp=8, bounces=3)
    pd = load_project(lua)
    scene = build_scene(pd)
    assert scene.use_clusters

    monkeypatch.setattr(simple_mod, "regen_enabled", lambda: True)
    monkeypatch.setattr(simple_mod, "regen_clusters_enabled", lambda: True)
    film, acc_r, wt_r = simple_mod.render(pd, scene, seed=2, max_samples=8)

    monkeypatch.setattr(simple_mod, "regen_enabled", lambda: False)
    film, acc_o, wt_o = simple_mod.render(pd, scene, seed=2, max_samples=8)

    s = pd.project.renderer.spectrum_samples
    expect_wt = 8 * film.width * film.height * s
    np.testing.assert_allclose(float(np.asarray(wt_r).sum()), expect_wt, rtol=1e-6)
    np.testing.assert_allclose(float(np.asarray(wt_o).sum()), expect_wt, rtol=1e-6)

    img_r = np.asarray(film.develop(acc_r, wt_r)).mean(axis=2)
    img_o = np.asarray(film.develop(acc_o, wt_o)).mean(axis=2)
    lit = img_o > 0.02
    rel = np.abs(img_r - img_o)[lit] / img_o[lit]
    assert np.median(rel) < 0.2, f"median rel {np.median(rel):.3f}"
    np.testing.assert_allclose(img_r[lit].mean(), img_o[lit].mean(), rtol=0.08)


def test_merged_traversal_matches_one_shot(tmp_path, monkeypatch):
    """PYRITE_TPU_MERGE_TRAV (tracer.merged_traversal_enabled): the deferred
    cluster scheduler runs each bounce's NEE shadow batch and the next
    bounce's extension rays through ONE merged traversal. PRNG draws and
    per-lane t semantics are identical to the in-line path, so the rendered
    image must match the one-shot wavefront to float tolerance."""
    import sys

    sys.path.insert(0, "/root/repo")
    from tools.synthetic import terrain_scene

    from pyrite_tpu import tracer as tracer_mod
    from pyrite_tpu.renderers import simple as simple_mod

    lua, _ = terrain_scene(
        str(tmp_path), cells=24, width=24, height=12, spp=4, bounces=3
    )
    pd = load_project(lua)
    scene = build_scene(pd)
    assert scene.use_clusters

    monkeypatch.setattr(simple_mod, "regen_enabled", lambda: False)
    film, acc_o, wt_o = simple_mod.render(pd, scene, seed=3, max_samples=4)

    monkeypatch.setattr(tracer_mod, "merged_traversal_enabled", lambda: True)
    film, acc_m, wt_m = simple_mod.render(pd, scene, seed=3, max_samples=4)

    np.testing.assert_array_equal(np.asarray(wt_o), np.asarray(wt_m))
    np.testing.assert_allclose(
        np.asarray(acc_m), np.asarray(acc_o), rtol=1e-5, atol=1e-7
    )


def test_intersect_merged_matches_split_queries(tmp_path):
    """intersect_merged must reproduce intersect_scene on its extension half
    and intersect_shadow on its shadow half for the same rays (cluster
    scene; seeded/pruned t, exit_below, inert-lane masking)."""
    import sys

    import jax
    import jax.numpy as jnp

    sys.path.insert(0, "/root/repo")
    from tools.synthetic import terrain_scene

    from pyrite_tpu import tracer

    lua, _ = terrain_scene(str(tmp_path), cells=24, width=8, height=4, spp=1, bounces=2)
    pd = load_project(lua)
    scene = build_scene(pd)
    assert scene.use_clusters
    cfg = tracer.TraceConfig(bounces=2, light_samples=1, spectrum_samples=2)

    n = 256
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    origin = jax.random.uniform(k1, (n, 3), minval=-6.0, maxval=6.0) + jnp.array([0.0, 6.0, 0.0])
    direction = origin * 0.0
    direction = jax.random.normal(k2, (n, 3))
    direction = direction / jnp.linalg.norm(direction, axis=1, keepdims=True)
    max_dist = jax.random.uniform(k3, (n,), minval=2.0, maxval=30.0)

    data = scene.device_data()

    def run(data):
        with scene.bind(data):
            ext = tracer.intersect_scene(scene, origin, direction, cfg)
            sh = tracer.intersect_shadow(
                scene, origin, direction, cfg,
                max_dist=max_dist,
                block_below=max_dist * 0.9,
            )
            o2 = jnp.concatenate([origin, origin], axis=0)
            d2 = jnp.concatenate([direction, direction], axis=0)
            t_seed = jnp.concatenate([max_dist, jnp.full(n, jnp.inf)])
            exit_b = jnp.concatenate([max_dist * 0.9, jnp.full(n, -jnp.inf)])
            is_sh = jnp.concatenate([jnp.ones(n, bool), jnp.zeros(n, bool)])
            merged = tracer.intersect_merged(
                scene, o2, d2, cfg, t_seed, exit_b, is_sh
            )
            return ext, sh, merged

    ext, sh, merged = jax.jit(run)(data)
    m_sh_t = np.asarray(merged["t"][:n])
    m_ext = {k: np.asarray(v[n:]) for k, v in merged.items()}

    # extension half == intersect_scene exactly
    np.testing.assert_array_equal(m_ext["t"], np.asarray(ext["t"]))
    np.testing.assert_array_equal(m_ext["kind"], np.asarray(ext["kind"]))
    np.testing.assert_array_equal(m_ext["idx"], np.asarray(ext["idx"]))
    # shadow half: exit_below stops a lane at its first definitive blocker,
    # so any t at or below the bound is equivalent (both mean "blocked");
    # unblocked lanes must agree exactly
    s_t = np.asarray(sh)
    bound = np.asarray(max_dist * 0.9)
    both_blocked = (m_sh_t < bound) & (s_t < bound)
    np.testing.assert_array_equal(
        m_sh_t[~both_blocked], s_t[~both_blocked]
    )


def test_bdpt_merged_traversal_matches_inline(tmp_path, monkeypatch):
    """BDPT camera walks on cluster scenes can merge the connection shadow
    batch, the NEE batch, and the next extension rays into one traversal
    (PYRITE_TPU_MERGE_TRAV). Identical PRNG streams and occlusion semantics:
    the film must match the in-line walk to float tolerance."""
    import sys

    sys.path.insert(0, "/root/repo")
    from tools.synthetic import terrain_scene

    from pyrite_tpu import tracer as tracer_mod
    from pyrite_tpu.renderers import bidirectional as bdpt_mod

    lua, _ = terrain_scene(
        str(tmp_path), cells=24, width=16, height=8, spp=2, bounces=3
    )
    src = open(lua).read().replace(
        "renderer.simple", "renderer.bidirectional"
    ).replace("light_samples = 1,", "light_samples = 1,\n        light_bounces = 3,")
    path = tmp_path / "terrain_bdpt.lua"
    path.write_text(src)
    pd = load_project(str(path))
    assert pd.project.renderer.light_bounces == 3
    scene = build_scene(pd)
    assert scene.use_clusters

    film, acc_o, wt_o = bdpt_mod.render(pd, scene, seed=5, max_samples=2)

    monkeypatch.setattr(tracer_mod, "merged_traversal_enabled", lambda: True)
    # the renderer module reads the gate through the tracer module at trace
    # time (make_render_step closes over it), so re-import is not needed
    monkeypatch.setattr(bdpt_mod, "merged_traversal_enabled", lambda: True)
    film, acc_m, wt_m = bdpt_mod.render(pd, scene, seed=5, max_samples=2)

    np.testing.assert_array_equal(np.asarray(wt_o), np.asarray(wt_m))
    np.testing.assert_allclose(
        np.asarray(acc_m), np.asarray(acc_o), rtol=1e-5, atol=1e-7
    )


def test_bdpt_deferred_regen_matches_inline_regen(tmp_path, monkeypatch):
    """Deferred regen-BDPT on cluster scenes (merged connection + NEE +
    extension traversal, regeneration mixed into the extension half): the
    PRNG streams align with the in-line regen body (pre-loop regen uses
    key 0, in-loop regen at iteration i uses key i+1 consumed at i+1), so
    the films must match to float tolerance."""
    import sys

    sys.path.insert(0, "/root/repo")
    from tools.synthetic import terrain_scene

    from pyrite_tpu import tracer as tracer_mod
    from pyrite_tpu.renderers import bidirectional as bdpt_mod

    lua, _ = terrain_scene(
        str(tmp_path), cells=24, width=16, height=8, spp=4, bounces=20
    )
    src = open(lua).read().replace(
        "renderer.simple", "renderer.bidirectional"
    ).replace("light_samples = 1,", "light_samples = 1,\n        light_bounces = 3,")
    path = tmp_path / "terrain_bdpt_deep.lua"
    path.write_text(src)
    pd = load_project(str(path))
    scene = build_scene(pd)
    assert scene.use_clusters
    assert pd.project.renderer.bounces >= bdpt_mod.REGEN_BDPT_MIN_BOUNCES

    film, acc_o, wt_o = bdpt_mod.render(pd, scene, seed=6, max_samples=4)

    monkeypatch.setattr(tracer_mod, "merged_traversal_enabled", lambda: True)
    monkeypatch.setattr(bdpt_mod, "merged_traversal_enabled", lambda: True)
    film, acc_m, wt_m = bdpt_mod.render(pd, scene, seed=6, max_samples=4)

    np.testing.assert_allclose(
        float(np.asarray(wt_m).sum()), float(np.asarray(wt_o).sum()), rtol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(acc_m), np.asarray(acc_o), rtol=1e-4, atol=1e-6
    )


def test_deferred_regen_on_cluster_scene(tmp_path, monkeypatch):
    """Cluster regen + merged traversal combined (the round-3 terrain
    configuration): exact per-pixel sample counts and one-shot-matching
    radiance. The deferred body regenerates dead lanes BEFORE the merged
    traversal so fresh camera rays ride the same launch as the NEE batch."""
    import sys

    sys.path.insert(0, "/root/repo")
    from tools.synthetic import terrain_scene

    from pyrite_tpu import tracer as tracer_mod
    from pyrite_tpu.renderers import simple as simple_mod

    lua, _ = terrain_scene(
        str(tmp_path), cells=24, width=24, height=12, spp=8, bounces=3
    )
    pd = load_project(lua)
    scene = build_scene(pd)
    assert scene.use_clusters

    monkeypatch.setattr(tracer_mod, "merged_traversal_enabled", lambda: True)
    monkeypatch.setattr(simple_mod, "regen_enabled", lambda: True)
    monkeypatch.setattr(simple_mod, "regen_clusters_enabled", lambda: True)
    film, acc_r, wt_r = simple_mod.render(pd, scene, seed=2, max_samples=8)

    monkeypatch.setattr(tracer_mod, "merged_traversal_enabled", lambda: False)
    monkeypatch.setattr(simple_mod, "regen_enabled", lambda: False)
    film, acc_o, wt_o = simple_mod.render(pd, scene, seed=2, max_samples=8)

    s = pd.project.renderer.spectrum_samples
    expect_wt = 8 * film.width * film.height * s
    np.testing.assert_allclose(float(np.asarray(wt_r).sum()), expect_wt, rtol=1e-6)

    img_r = np.asarray(film.develop(acc_r, wt_r)).mean(axis=2)
    img_o = np.asarray(film.develop(acc_o, wt_o)).mean(axis=2)
    lit = img_o > 0.02
    rel = np.abs(img_r - img_o)[lit] / img_o[lit]
    assert np.median(rel) < 0.2, f"median rel {np.median(rel):.3f}"
    np.testing.assert_allclose(img_r[lit].mean(), img_o[lit].mean(), rtol=0.08)


def test_regen_bdpt_matches_one_shot(tmp_path, monkeypatch):
    """Deep camera budgets (>= REGEN_BDPT_MIN_BOUNCES) ride camera-side path
    regeneration in the BDPT renderer: every sample pairs with its own lamp
    path and wavelengths (rounds == launch sample count), splats are exposed
    per round, and finished camera samples accumulate into per-lane bins.
    The estimator must match the one-shot walk statistically, with the same
    total film weight up to connection-count noise."""
    from pyrite_tpu.renderers import bidirectional as bdpt_mod

    src = SCENE % {"algo": "bidirectional", "spp": 60, "extra": ""}
    src = src.replace("bounces = 4", "bounces = 20")
    path = tmp_path / "regen_bdpt.lua"
    path.write_text(src)
    pd = load_project(str(path))
    scene = build_scene(pd)
    assert pd.project.renderer.bounces >= bdpt_mod.REGEN_BDPT_MIN_BOUNCES

    film, acc_r, wt_r = bdpt_mod.render(pd, scene, seed=4, max_samples=60)
    # determinism: same seed -> identical film
    film, acc_r2, _ = bdpt_mod.render(pd, scene, seed=4, max_samples=60)
    np.testing.assert_array_equal(np.asarray(acc_r), np.asarray(acc_r2))

    monkeypatch.setattr(bdpt_mod, "regen_enabled", lambda: False)
    film, acc_o, wt_o = bdpt_mod.render(pd, scene, seed=4, max_samples=60)

    # film weight: camera samples contribute exactly spp*pixels*S when no
    # dispersal occurs; connection/splat weights are stochastic — bound the
    # totals within a few percent of each other
    tw_r = float(np.asarray(wt_r).sum())
    tw_o = float(np.asarray(wt_o).sum())
    np.testing.assert_allclose(tw_r, tw_o, rtol=0.03)

    img_r = np.asarray(film.develop(acc_r, wt_r)).mean(axis=2)
    img_o = np.asarray(film.develop(acc_o, wt_o)).mean(axis=2)
    lit = img_o > 0.02
    rel = np.abs(img_r - img_o)[lit] / img_o[lit]
    assert np.median(rel) < 0.2, f"median rel {np.median(rel):.3f}"
    np.testing.assert_allclose(img_r[lit].mean(), img_o[lit].mean(), rtol=0.06)


def test_regen_bdpt_substack_flush_matches(tmp_path, monkeypatch):
    """The regen-BDPT driver stacks per-round connection trees under a byte
    budget (deep lamp budgets can realize K' = 256 compacted slots: dragon's
    stacked trees reach 10.7 GB and the compile OOMs), flushing a camera
    walk per sub-stack. Flushing must leave the estimator unchanged: exact
    sample counts, splats identical, radiance within noise of the unflushed
    driver (only the per-sub-stack camera jitter keys differ)."""
    from pyrite_tpu.renderers import bidirectional as bdpt_mod

    src = SCENE % {
        "algo": "bidirectional", "spp": 24,
        "extra": ", light_bounces = 20",
    }
    src = src.replace("bounces = 4", "bounces = 20")
    path = tmp_path / "substack.lua"
    path.write_text(src)
    pd = load_project(str(path))
    scene = build_scene(pd)
    assert pd.project.renderer.bounces >= bdpt_mod.REGEN_BDPT_MIN_BOUNCES
    assert pd.project.renderer.light_bounces + 1 > 16  # compacting path

    film, acc_a, wt_a = bdpt_mod.render(pd, scene, seed=3, max_samples=24)
    monkeypatch.setattr(bdpt_mod, "_CONN_STACK_BUDGET", 1)  # flush per round
    film, acc_b, wt_b = bdpt_mod.render(pd, scene, seed=3, max_samples=24)

    tw_a = float(np.asarray(wt_a).sum())
    tw_b = float(np.asarray(wt_b).sum())
    np.testing.assert_allclose(tw_a, tw_b, rtol=0.03)

    img_a = np.asarray(film.develop(acc_a, wt_a)).mean(axis=2)
    img_b = np.asarray(film.develop(acc_b, wt_b)).mean(axis=2)
    lit = img_a > 0.02
    rel = np.abs(img_b - img_a)[lit] / img_a[lit]
    assert np.median(rel) < 0.2, f"median rel {np.median(rel):.3f}"
    np.testing.assert_allclose(img_b[lit].mean(), img_a[lit].mean(), rtol=0.06)


def test_bdpt_grouped_connections_match_flat(tmp_path, monkeypatch):
    """Slot-grouped connection folding (_connect_fold_grouped with K' >
    _CONN_GROUP_SLOTS) must reproduce the single flat query: the RNG
    streams are identical (grouping changes no draws), so the films agree
    to float tolerance (the fold reassociates sums across groups)."""
    from pyrite_tpu.renderers import bidirectional as bdpt_mod

    src = SCENE % {
        "algo": "bidirectional", "spp": 8,
        "extra": ", light_bounces = 20",
    }
    path = tmp_path / "grouped.lua"
    path.write_text(src)
    pd = load_project(str(path))
    scene = build_scene(pd)

    film, acc_a, wt_a = bdpt_mod.render(pd, scene, seed=6, max_samples=8)
    monkeypatch.setattr(bdpt_mod, "_CONN_GROUP_SLOTS", 4)
    film, acc_b, wt_b = bdpt_mod.render(pd, scene, seed=6, max_samples=8)

    np.testing.assert_allclose(
        np.asarray(acc_b), np.asarray(acc_a), rtol=2e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(wt_b), np.asarray(wt_a), rtol=2e-4, atol=1e-5
    )

    # the unrolled group loop (PYRITE_TPU_CONN_UNROLL: Python loop instead
    # of lax.map) is the same math
    monkeypatch.setattr(bdpt_mod, "_CONN_UNROLL", 1)
    film, acc_c, wt_c = bdpt_mod.render(pd, scene, seed=6, max_samples=8)
    np.testing.assert_allclose(
        np.asarray(acc_c), np.asarray(acc_b), rtol=2e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(wt_c), np.asarray(wt_b), rtol=2e-4, atol=1e-5
    )


def test_staged_cam_walk_matches_one_shot(tmp_path, monkeypatch):
    """Cluster-scene regen-BDPT camera walks run STAGED (bounded launches
    with host-side carry — one unbounded launch at dragon scale runs
    minutes of grouped cluster shadow walks).
    The fold_in streams key on the global iteration counter carried across
    launches, so staging must reproduce the one-shot walk to float
    tolerance (only XLA program boundaries differ)."""
    import sys

    sys.path.insert(0, "/root/repo")
    from tools.synthetic import terrain_scene

    from pyrite_tpu.renderers import bidirectional as bdpt_mod

    lua, _ = terrain_scene(
        str(tmp_path), cells=24, width=16, height=8, spp=4, bounces=20
    )
    src = open(lua).read().replace(
        "renderer.simple", "renderer.bidirectional"
    ).replace(
        "light_samples = 1,",
        "light_samples = 1,\n        light_bounces = 3,",
    )
    path = tmp_path / "terrain_bdpt_staged.lua"
    path.write_text(src)
    pd = load_project(str(path))
    scene = build_scene(pd)
    assert scene.use_clusters
    assert pd.project.renderer.bounces >= bdpt_mod.REGEN_BDPT_MIN_BOUNCES

    monkeypatch.setattr(bdpt_mod, "_CAM_ITER_CAP", 0)  # one-shot
    film, acc_o, wt_o = bdpt_mod.render(pd, scene, seed=6, max_samples=4)

    monkeypatch.setattr(bdpt_mod, "_CAM_ITER_CAP", 3)  # staged, tiny cap
    film, acc_s, wt_s = bdpt_mod.render(pd, scene, seed=6, max_samples=4)

    np.testing.assert_allclose(
        np.asarray(wt_s), np.asarray(wt_o), rtol=1e-6, atol=1e-7
    )
    np.testing.assert_allclose(
        np.asarray(acc_s), np.asarray(acc_o), rtol=1e-5, atol=1e-7
    )


def test_splat_ragged_compaction_matches_single_batch(tmp_path, monkeypatch):
    """The compacted splat shadow walk (valid (lane, slot) pairs argsorted
    first, only ceil(count/cap) cap-wide chunks walked) must expose the
    same film as the single full-width batch — compaction only reorders
    inert-padding work, never verdicts."""
    import jax

    from pyrite_tpu.film import Film
    from pyrite_tpu.renderers import bidirectional as bd
    from pyrite_tpu.scene import CameraModel
    from pyrite_tpu.tracer import TraceConfig

    src = SCENE % {"algo": "bidirectional", "spp": 4,
                   "extra": ", light_bounces = 12"}
    path = tmp_path / "splat.lua"
    path.write_text(src)
    pd = load_project(str(path))
    scene = build_scene(pd)
    project = pd.project
    film = Film(width=project.image.width, height=project.image.height,
                bins=project.renderer.spectrum_bins,
                span=project.renderer.spectrum_span)
    camera = CameraModel.from_ir(project.camera)
    cfg = TraceConfig(bounces=3, light_samples=1, spectrum_samples=4)

    from pyrite_tpu.tracer import trace_lamp_path

    key = jax.random.PRNGKey(11)
    data = scene.device_data()
    with scene.bind(data):
        n = 64
        lo, hi = film.span
        wl = jax.random.uniform(key, (n, 4), minval=lo, maxval=hi)
        lamp_cfg = TraceConfig(bounces=12, light_samples=0, spectrum_samples=4)
        lpath = trace_lamp_path(scene, lamp_cfg, key, wl)
        conn = bd._connection_arrays(scene, lpath, wl, cfg, key)

        acc0, wt0 = film.new_buffers()
        acc_a, wt_a = bd._light_splats(
            scene, film, camera, cfg, conn, wl, acc0, wt0
        )

        # force the chunked path (m = 64 * 13 = 832 queries > cap = 128)
        monkeypatch.setattr(bd, "_splat_shadow_cap", lambda s: 128)
        acc0, wt0 = film.new_buffers()
        acc_b, wt_b = bd._light_splats(
            scene, film, camera, cfg, conn, wl, acc0, wt0
        )
    np.testing.assert_allclose(
        np.asarray(acc_b), np.asarray(acc_a), rtol=1e-5, atol=1e-7
    )
    np.testing.assert_allclose(
        np.asarray(wt_b), np.asarray(wt_a), rtol=1e-5, atol=1e-7
    )


def test_deferred_connections_match_inline(tmp_path, monkeypatch):
    """Deferred connections (PYRITE_TPU_CONN_DEFER: the regen walk records
    diffuse vertices and the finish step batches every connection shadow
    walk top-level) must reproduce the in-loop fold: no RNG draws differ,
    only the fold's sum association, so films agree to float tolerance."""
    import sys

    sys.path.insert(0, "/root/repo")
    from tools.synthetic import terrain_scene

    from pyrite_tpu.renderers import bidirectional as bdpt_mod

    lua, _ = terrain_scene(
        str(tmp_path), cells=24, width=16, height=8, spp=4, bounces=20
    )
    src = open(lua).read().replace(
        "renderer.simple", "renderer.bidirectional"
    ).replace(
        "light_samples = 1,",
        "light_samples = 1,\n        light_bounces = 3,",
    )
    path = tmp_path / "terrain_bdpt_defer.lua"
    path.write_text(src)
    pd = load_project(str(path))
    scene = build_scene(pd)
    assert scene.use_clusters
    assert pd.project.renderer.bounces >= bdpt_mod.REGEN_BDPT_MIN_BOUNCES

    monkeypatch.setattr(bdpt_mod, "_CONN_DEFER", 0)
    film, acc_i, wt_i = bdpt_mod.render(pd, scene, seed=6, max_samples=4)

    monkeypatch.setattr(bdpt_mod, "_CONN_DEFER", 1)
    film, acc_d, wt_d = bdpt_mod.render(pd, scene, seed=6, max_samples=4)

    np.testing.assert_allclose(
        np.asarray(wt_d), np.asarray(wt_i), rtol=1e-5, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(acc_d), np.asarray(acc_i), rtol=1e-4, atol=1e-6
    )

    # staged + deferred combined (the dragon-class configuration)
    monkeypatch.setattr(bdpt_mod, "_CAM_ITER_CAP", 3)
    film, acc_sd, wt_sd = bdpt_mod.render(pd, scene, seed=6, max_samples=4)
    np.testing.assert_allclose(
        np.asarray(acc_sd), np.asarray(acc_d), rtol=1e-5, atol=1e-7
    )
    np.testing.assert_allclose(
        np.asarray(wt_sd), np.asarray(wt_d), rtol=1e-5, atol=1e-7
    )
