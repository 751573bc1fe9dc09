import numpy as np
import pytest

from pyrite_tpu import geometry as geom
from pyrite_tpu import bvh as bvh_mod


def test_ray_triangle_hit_and_miss():
    o = np.array([[0.0, 0.0, -1.0]])
    d = np.array([[0.0, 0.0, 1.0]])
    v0 = np.array([[-1.0, -1.0, 0.0]])
    e1 = np.array([[2.0, 0.0, 0.0]])
    e2 = np.array([[0.0, 2.0, 0.0]])
    hit, t, u, v = geom.ray_triangle(o, d, v0, e1, e2)
    assert bool(hit[0])
    assert float(t[0]) == pytest.approx(1.0, abs=1e-5)
    # barycentric of the center
    assert float(u[0]) == pytest.approx(0.5, abs=1e-5)
    assert float(v[0]) == pytest.approx(0.5, abs=1e-5)

    o2 = np.array([[5.0, 5.0, -1.0]])
    hit2, t2, _, _ = geom.ray_triangle(o2, d, v0, e1, e2)
    assert not bool(hit2[0])
    assert np.isinf(float(t2[0]))


def test_ray_sphere_outside_and_inside():
    c = np.array([[0.0, 0.0, 5.0]])
    r = np.array([2.0])
    o = np.array([[0.0, 0.0, 0.0]])
    d = np.array([[0.0, 0.0, 1.0]])
    hit, t = geom.ray_sphere(o, d, c, r)
    assert bool(hit[0]) and float(t[0]) == pytest.approx(3.0, abs=1e-5)
    # from inside: nearest positive root is the exit
    o_in = np.array([[0.0, 0.0, 5.0]])
    hit, t = geom.ray_sphere(o_in, d, c, r)
    assert bool(hit[0]) and float(t[0]) == pytest.approx(2.0, abs=1e-5)


def test_ray_plane():
    n = np.array([[0.0, 1.0, 0.0]])
    d_plane = np.array([0.0])
    o = np.array([[0.0, 3.0, 0.0]])
    d = np.array([[0.0, -1.0, 0.0]])
    hit, t = geom.ray_plane(o, d, n, d_plane)
    assert bool(hit[0]) and float(t[0]) == pytest.approx(3.0, abs=1e-5)
    # parallel ray misses
    d_par = np.array([[1.0, 0.0, 0.0]])
    hit, _ = geom.ray_plane(o, d_par, n, d_plane)
    assert not bool(hit[0])


def test_quat_roundtrip_rotation():
    rng = np.random.default_rng(1)
    # random orthonormal frame
    x = rng.normal(size=3)
    x /= np.linalg.norm(x)
    y, z = geom.basis(x[None])
    y = np.asarray(y[0])
    z = np.asarray(z[0])
    q = geom.mat3_cols_to_quat(y[None], z[None], x[None])
    v = np.array([[0.3, -0.2, 0.9]])
    rotated = np.asarray(geom.quat_rotate(q, v))
    expected = (y * 0.3 - z * 0.2 + x * 0.9)[None]
    np.testing.assert_allclose(rotated, expected, atol=1e-5)
    # conjugate inverts
    back = np.asarray(geom.quat_rotate(geom.quat_conj(q), rotated))
    np.testing.assert_allclose(back, v, atol=1e-5)


def test_sample_hemisphere_respects_direction():
    rng = np.random.default_rng(2)
    u = rng.random((64,))
    v = rng.random((64,))
    n = np.tile(np.array([[0.0, 1.0, 0.0]]), (64, 1))
    dirs = np.asarray(geom.sample_hemisphere(u, v, n))
    assert np.all(np.einsum("nd,nd->n", dirs, n) >= -1e-6)
    np.testing.assert_allclose(np.linalg.norm(dirs, axis=1), 1.0, atol=1e-4)


def test_bvh_matches_brute_force():
    import jax.numpy as jnp
    from pyrite_tpu import geometry

    rng = np.random.default_rng(3)
    num = 50
    centers = rng.uniform(-5, 5, size=(num, 3)).astype(np.float32)
    radii = rng.uniform(0.1, 0.6, size=num).astype(np.float32)
    lo = centers - radii[:, None]
    hi = centers + radii[:, None]
    flat = bvh_mod.build_bvh(lo, hi)
    assert flat.num_nodes == 2 * num - 1
    # leaves hold each primitive exactly once
    leaves = flat.prim_index[flat.prim_index >= 0]
    assert sorted(leaves.tolist()) == list(range(num))

    n_rays = 32
    origins = rng.uniform(-8, 8, size=(n_rays, 3)).astype(np.float32)
    dirs = rng.normal(size=(n_rays, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)

    c_j = jnp.asarray(centers)
    r_j = jnp.asarray(radii)

    def intersect_prim(prim, o, d, state):
        ok, t = geometry.ray_sphere(o, d, c_j[prim], r_j[prim])
        better = ok & (t < state["t"])
        return {"t": jnp.where(better, t, state["t"]),
                "idx": jnp.where(better, prim, state["idx"])}

    arrays = {
        "bbox_min": jnp.asarray(flat.bbox_min),
        "bbox_max": jnp.asarray(flat.bbox_max),
        "subtree_size": jnp.asarray(flat.subtree_size),
        "prim_index": jnp.asarray(flat.prim_index),
    }
    init = {"t": jnp.full(n_rays, jnp.inf), "idx": jnp.full(n_rays, -1)}
    out = bvh_mod.traverse(arrays, jnp.asarray(origins), jnp.asarray(dirs),
                           intersect_prim, init, flat.num_nodes)

    # brute force
    hit_all, t_all = geometry.ray_sphere(
        origins[:, None, :], dirs[:, None, :], centers[None], radii[None]
    )
    t_all = np.where(np.asarray(hit_all), np.asarray(t_all), np.inf)
    best = t_all.min(axis=1)
    np.testing.assert_allclose(np.asarray(out["t"]), best, rtol=1e-4)


def test_native_builders_match_python():
    from pyrite_tpu import native
    from pyrite_tpu.project.meshes import load_obj

    if not native.available():
        import pytest

        pytest.skip("native library unavailable")

    box = "/root/reference/pyrite/test/cornell/box.obj"
    py = load_obj(box)
    nat = native.load_obj(box)
    assert [o.name for o in py.objects] == [o.name for o in nat.objects]
    np.testing.assert_allclose(py.positions, nat.positions)
    for a, b in zip(py.objects, nat.objects):
        np.testing.assert_array_equal(a.faces_v, b.faces_v)
        np.testing.assert_array_equal(a.faces_vn, b.faces_vn)
        np.testing.assert_array_equal(a.faces_vt, b.faces_vt)

    rng = np.random.default_rng(5)
    n = 500
    c = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    r = rng.uniform(0.05, 0.3, (n, 1)).astype(np.float32)
    res = native.build_bvh(c - r, c + r)
    assert res is not None
    bmin, bmax, subtree, prim = res
    assert len(subtree) == 2 * n - 1
    assert sorted(prim[prim >= 0].tolist()) == list(range(n))
    # skip-link structure: walking with subtree sizes visits every node once
    i = 0
    visited = 0
    while i < len(subtree):
        visited += 1
        i += 1
    assert visited == len(subtree)


def test_expose_lanes_matches_scatter_expose():
    import jax
    import jax.numpy as jnp
    from pyrite_tpu.film import Film, expose_lanes

    film = Film(width=8, height=6, bins=16, span=(380.0, 780.0))
    rng = np.random.default_rng(7)
    n, s = 8 * 6, 5
    # jittered positions inside each pixel, row-major lanes
    py, px = np.meshgrid(np.arange(6), np.arange(8), indexing="ij")
    pxf = px.reshape(-1) + rng.random(n)
    pyf = py.reshape(-1) + rng.random(n)
    positions = np.asarray(film.pixel_to_view(jnp.asarray(pxf), jnp.asarray(pyf)))

    wavelengths = jnp.asarray(rng.uniform(380, 780, (n, s)), jnp.float32)
    brightness = jnp.asarray(rng.random((n, s)), jnp.float32)
    weights = jnp.asarray(rng.random((n, s)), jnp.float32)
    mask = jnp.asarray(rng.random((n, s)) > 0.3)

    acc0, wt0 = film.new_buffers()
    a1, w1 = film.expose(acc0, wt0, jnp.asarray(positions), wavelengths, brightness, weights, mask)
    a2, w2 = expose_lanes(film, acc0, wt0, 0, wavelengths, brightness, weights, mask)
    np.testing.assert_allclose(np.asarray(a1), np.asarray(a2), atol=1e-5)
    np.testing.assert_allclose(np.asarray(w1), np.asarray(w2), atol=1e-5)


def test_python_clustered_build_matches_brute_force():
    """The numpy clustered builder (no-native fallback) must produce a tree
    whose batched traversal returns brute-force-identical closest hits."""
    import types

    import jax.numpy as jnp
    from pyrite_tpu import tracer
    from pyrite_tpu.scene import PRIM_TRIANGLE

    rng = np.random.default_rng(11)
    num = 2500  # > a few leaves at CLUSTER_LEAF, still fast on CPU
    v0 = rng.uniform(-5, 5, size=(num, 3)).astype(np.float32)
    e1 = rng.normal(scale=0.4, size=(num, 3)).astype(np.float32)
    e2 = rng.normal(scale=0.4, size=(num, 3)).astype(np.float32)
    lo = np.minimum(np.minimum(v0, v0 + e1), v0 + e2)
    hi = np.maximum(np.maximum(v0, v0 + e1), v0 + e2)

    cl_min, cl_max, subtree, start, count, perm = bvh_mod.build_bvh_clustered_python(
        lo, hi, 32
    )
    # structure: every primitive appears exactly once across leaf ranges
    assert sorted(perm.tolist()) == list(range(num))
    leaves = count > 0
    assert (count[leaves] <= 32).all()
    assert count[leaves].sum() == num
    # skip-link consistency: leaf subtree sizes are 0, walk covers all nodes
    assert (subtree[leaves] == 0).all()

    from pyrite_tpu.scene import pack_wide_clusters

    geo = np.zeros((num, 12), np.float32)
    geo[:, 0:3] = v0[perm]
    geo[:, 3:6] = e1[perm]
    geo[:, 6:9] = e2[perm]
    geo[:, 10] = PRIM_TRIANGLE
    geo[:, 11] = perm
    rows, packed_geo = pack_wide_clusters(
        lo[perm], hi[perm], geo, tracer.CLUSTER_LEAF
    )
    scene = types.SimpleNamespace(
        cluster_slots=packed_geo.shape[0],
        cluster_leaf=tracer.CLUSTER_LEAF,
        arrays={
            "wide_rows": jnp.asarray(rows),
            "clu_geo": jnp.asarray(packed_geo),
        },
    )

    n_rays = 64
    origins = rng.uniform(-8, 8, size=(n_rays, 3)).astype(np.float32)
    dirs = rng.normal(size=(n_rays, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)

    init = {
        "t": jnp.full(n_rays, jnp.inf),
        "kind": jnp.zeros(n_rays, jnp.int32),
        "idx": jnp.zeros(n_rays, jnp.int32),
        "u": jnp.zeros(n_rays),
        "v": jnp.zeros(n_rays),
    }
    out = tracer._cluster_traverse(
        scene, jnp.asarray(origins), jnp.asarray(dirs), init,
        tracer._cluster_leaf_closest(scene),
    )

    ok, t, _, _ = geom.ray_triangle(
        origins[:, None, :], dirs[:, None, :], v0[None], e1[None], e2[None]
    )
    t_all = np.where(np.asarray(ok), np.asarray(t), np.inf)
    best_t = t_all.min(axis=1)
    np.testing.assert_allclose(np.asarray(out["t"]), best_t, rtol=1e-5)
    hit_rays = np.isfinite(best_t)
    np.testing.assert_array_equal(
        np.asarray(out["idx"])[hit_rays], t_all.argmin(axis=1)[hit_rays]
    )

    # exercise the ray-compaction path too (default threshold needs >= 4096
    # lanes; force it down so the 64-ray batch takes the compacted sweeps)
    old_min = tracer.COMPACT_MIN
    try:
        tracer.COMPACT_MIN = 16
        out_c = tracer._cluster_traverse(
            scene, jnp.asarray(origins), jnp.asarray(dirs), init,
            tracer._cluster_leaf_closest(scene),
        )
        np.testing.assert_allclose(np.asarray(out_c["t"]), best_t, rtol=1e-5)
        np.testing.assert_array_equal(
            np.asarray(out_c["idx"])[hit_rays], t_all.argmin(axis=1)[hit_rays]
        )
    finally:
        tracer.COMPACT_MIN = old_min

    # the one-hot row fetch is width-gated (CLUSTER_ONEHOT_MAX): above
    # the cap the walk falls back to the dynamic row-gather. Pin both fetch
    # paths to the same hits (gate forced to 0 => every width uses gather).
    old_max = tracer.CLUSTER_ONEHOT_MAX
    try:
        tracer.CLUSTER_ONEHOT_MAX = 0
        out_g = tracer._cluster_traverse(
            scene, jnp.asarray(origins), jnp.asarray(dirs), init,
            tracer._cluster_leaf_closest(scene),
        )
        np.testing.assert_allclose(np.asarray(out_g["t"]), best_t, rtol=1e-5)
        np.testing.assert_array_equal(
            np.asarray(out_g["idx"])[hit_rays], t_all.argmin(axis=1)[hit_rays]
        )
    finally:
        tracer.CLUSTER_ONEHOT_MAX = old_max


def test_fused_sweep_in_xla_walk_matches_brute_force():
    """The Triton-route leaf sweep (interpret mode on CPU) inside the XLA
    walk must produce brute-force-identical closest hits and shadow
    distances, including through the ray-compaction path."""
    import types

    import jax.numpy as jnp
    from pyrite_tpu import kernels, tracer
    from pyrite_tpu.scene import PRIM_TRIANGLE, pack_wide_clusters

    rng = np.random.default_rng(31)
    num = 2500
    v0 = rng.uniform(-5, 5, size=(num, 3)).astype(np.float32)
    e1 = rng.normal(scale=0.4, size=(num, 3)).astype(np.float32)
    e2 = rng.normal(scale=0.4, size=(num, 3)).astype(np.float32)
    lo = np.minimum(np.minimum(v0, v0 + e1), v0 + e2)
    hi = np.maximum(np.maximum(v0, v0 + e1), v0 + e2)

    _, _, _, _, _, perm = bvh_mod.build_bvh_clustered_python(lo, hi, 32)
    geo = np.zeros((num, 12), np.float32)
    geo[:, 0:3] = v0[perm]
    geo[:, 3:6] = e1[perm]
    geo[:, 6:9] = e2[perm]
    geo[:, 10] = PRIM_TRIANGLE
    geo[:, 11] = perm
    rows, packed_geo = pack_wide_clusters(lo[perm], hi[perm], geo, tracer.CLUSTER_LEAF)
    scene = types.SimpleNamespace(
        cluster_slots=packed_geo.shape[0],
        cluster_leaf=tracer.CLUSTER_LEAF,
        arrays={
            "wide_rows": jnp.asarray(rows),
            "clu_geo": jnp.asarray(packed_geo),
            "clu_geo_ch": jnp.asarray(kernels.pack_geo_channel_major(packed_geo)),
        },
    )

    n_rays = 48
    origins = rng.uniform(-8, 8, size=(n_rays, 3)).astype(np.float32)
    dirs = rng.normal(size=(n_rays, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)

    init = {
        "t": jnp.full(n_rays, jnp.inf),
        "kind": jnp.zeros(n_rays, jnp.int32),
        "idx": jnp.zeros(n_rays, jnp.int32),
        "u": jnp.zeros(n_rays),
        "v": jnp.zeros(n_rays),
    }
    old_min = tracer.COMPACT_MIN
    try:
        with kernels.use_path("interpret"):
            out = tracer._cluster_traverse(
                scene, jnp.asarray(origins), jnp.asarray(dirs), init,
                tracer._cluster_leaf_closest(scene),
            )
            # compacted sweeps too (default threshold needs >= 4096 lanes)
            tracer.COMPACT_MIN = 16
            out_c = tracer._cluster_traverse(
                scene, jnp.asarray(origins), jnp.asarray(dirs), init,
                tracer._cluster_leaf_closest(scene),
            )
            shadow = tracer._cluster_traverse(
                scene, jnp.asarray(origins), jnp.asarray(dirs),
                {"t": jnp.full(n_rays, jnp.inf)},
                tracer._cluster_leaf_shadow(scene),
            )
    finally:
        tracer.COMPACT_MIN = old_min

    ok, t, _, _ = geom.ray_triangle(
        origins[:, None, :], dirs[:, None, :], v0[None], e1[None], e2[None]
    )
    t_all = np.where(np.asarray(ok), np.asarray(t), np.inf)
    best_t = t_all.min(axis=1)
    hit_rays = np.isfinite(best_t)
    assert hit_rays.sum() > 5
    for result in (out, out_c):
        np.testing.assert_allclose(np.asarray(result["t"]), best_t, rtol=1e-5)
        np.testing.assert_array_equal(
            np.asarray(result["idx"])[hit_rays], t_all.argmin(axis=1)[hit_rays]
        )
    np.testing.assert_allclose(np.asarray(shadow["t"]), best_t, rtol=1e-5)


def test_sweep_kernel_choice_and_layout():
    """The kernel sweep is chosen only off the XLA path and for leaves made
    of whole 128-primitive tiles; the channel-major table puts channel c of
    leaf s on row s * 12 + c."""
    import types

    from pyrite_tpu import kernels, tracer

    geo = np.arange(2 * 128 * 12, dtype=np.float32).reshape(2, 128, 12)
    ch = kernels.pack_geo_channel_major(geo)
    assert ch.shape == (24, 128)
    np.testing.assert_array_equal(ch[1 * 12 + 5], geo[1, :, 5])
    scene = types.SimpleNamespace(cluster_leaf=128, arrays={})
    assert tracer._kernel_leaf_sweep(scene, shadow=False) is None  # CPU: XLA
    with kernels.use_path("interpret"):
        assert tracer._kernel_leaf_sweep(scene, shadow=True) is not None
        scene.cluster_leaf = 96
        assert tracer._kernel_leaf_sweep(scene, shadow=True) is None


_MARCH_SHAPES = {
    "julia_regular": dict(
        estimator={
            "kind": "quaternion_julia",
            "iterations": 12,
            "threshold": 4.0,
            "constant": np.asarray([-0.2, 0.8, 0.0, 0.0], np.float32),
            "slice_plane": 0.0,
            "variant": "regular",
        },
        radius=1.5,
    ),
    "julia_cubic": dict(
        estimator={
            "kind": "quaternion_julia",
            "iterations": 12,
            "threshold": 4.0,
            "constant": np.asarray([-0.2, 0.8, 0.0, 0.0], np.float32),
            "slice_plane": 0.0,
            "variant": "cubic",
        },
        radius=1.5,
    ),
    "mandelbulb": dict(
        estimator={
            "kind": "mandelbulb",
            "iterations": 10,
            "threshold": 4.0,
            "power": 8.0,
            "constant": None,
        },
        radius=1.6,
    ),
}


@pytest.mark.parametrize("omega", ["1.0", "1.6"])
@pytest.mark.parametrize("shape_name", sorted(_MARCH_SHAPES))
def test_pallas_march_matches_xla_march(shape_name, omega, monkeypatch):
    """The Triton-route DE sphere-trace kernel (interpret mode on CPU) must
    match the XLA while-loop march, plain and over-relaxed. 300 lanes is
    not a multiple of the kernel's lane block, so the padding is covered."""
    import jax.numpy as jnp
    from pyrite_tpu import kernels, tracer
    from pyrite_tpu.scene import DEShape

    monkeypatch.setenv("PYRITE_TPU_DE_OMEGA", omega)
    spec = _MARCH_SHAPES[shape_name]
    shape = DEShape(
        estimator=spec["estimator"],
        bounds_kind="sphere",
        bounds_a=np.zeros(3, np.float32),
        bounds_b=np.asarray([spec["radius"], 0, 0], np.float32),
        material_id=0,
    )

    rng = np.random.default_rng(3)
    n = 300
    assert n % kernels.MARCH_BLOCK != 0
    origins_np = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    # aim at the shape (with jitter) so a healthy fraction of rays hit
    targets = rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)
    dirs = targets - origins_np
    dirs = jnp.asarray(dirs / np.linalg.norm(dirs, axis=1, keepdims=True))
    origins = jnp.asarray(origins_np)

    with kernels.use_path("xla"):
        ok_x, t_x, _ = tracer._intersect_de(shape, origins, dirs, 128)
    with kernels.use_path("interpret"):
        ok_p, t_p, _ = tracer._intersect_de(shape, origins, dirs, 128)
    np.testing.assert_array_equal(np.asarray(ok_x), np.asarray(ok_p))
    # The plain march (omega 1.0) creeps up on grazing surfaces for up to
    # max_steps steps, so a last-ulp difference in the estimator (the two
    # computations fuse differently) can end a lane one step apart; its t
    # still sits within the march's own hit epsilon of the other's.
    atol = 1e-5 if omega == "1.6" else tracer.DIST_EPSILON
    np.testing.assert_allclose(
        np.asarray(t_x)[np.asarray(ok_x)],
        np.asarray(t_p)[np.asarray(ok_p)],
        rtol=1e-5, atol=atol,
    )
    assert int(np.asarray(ok_x).sum()) > 5  # the test actually hits


def test_kernel_path_rule_on_cpu():
    """On the CPU the march takes the XLA path, and the compiled Triton
    kernel is refused rather than silently interpreted or replaced."""
    import jax.numpy as jnp
    from pyrite_tpu import kernels

    assert kernels.kernel_path() == "xla"
    est = _MARCH_SHAPES["julia_regular"]["estimator"]
    n = 8
    args = (
        est, jnp.zeros((n, 3)), jnp.ones((n, 3)), jnp.zeros(n),
        jnp.ones(n), jnp.ones(n, bool), 16,
    )
    with kernels.use_path("kernel"):
        assert kernels.kernel_path() == "kernel"
        with pytest.raises(RuntimeError, match="compiles only for a GPU"):
            kernels.march_de(*args)
    with pytest.raises(ValueError):
        kernels.march_de(*args)  # the XLA path has no kernel to call
    with pytest.raises(ValueError):
        kernels.use_path("bogus")
    assert kernels.kernel_path() == "xla"
