"""Wavefront path tracer core.

The reference traces one path per CPU thread to completion with a pointer-
chasing megakernel (tracer.rs:208-345). Here a whole wavefront of rays is
advanced one bounce per step inside jit: intersection against the flattened
scene (planes linear scan + BVH skip-link walk + distance-estimated shapes),
branchless material component selection and BSDF scattering, next-event
estimation, and streaming radiance accumulation. The per-bounce contribution
recurrence reproduces renderer/algorithm.rs:14-100 exactly, but fused into
the loop (no stored path): emission adds color*probability*throughput,
reflection multiplies throughput by color*probability then adds direct light
then multiplies by the BRDF. Auxiliary (non-hero) wavelengths stop updating
after the first dispersive bounce and are discarded at exposure if any bounce
dispersed (simple.rs:120-139 semantics).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from . import bvh as bvh_mod
from . import geometry as geom
from .exprs import ProgramInputs
from .scene import (
    BSDF_DIFFUSE,
    BSDF_EMISSIVE,
    BSDF_MIRROR,
    BSDF_REFRACTIVE,
    CLUSTER_LEAF,
    CLUSTER_THRESHOLD,
    LAMP_DIRECTIONAL,
    LAMP_POINT,
    LAMP_SPHERE,
    LAMP_TRIANGLE,
    PRIM_SPHERE,
    PRIM_TRIANGLE,
    Scene,
)

DIST_EPSILON = geom.DIST_EPSILON

# hit kinds
KIND_NONE = 0
KIND_TRIANGLE = 1
KIND_SPHERE = 2
KIND_PLANE = 3
KIND_DE = 4  # DE shape j encoded as idx=j


@dataclass(frozen=True)
class TraceConfig:
    bounces: int
    light_samples: int
    spectrum_samples: int
    max_de_steps: int = 200


# =============================================================================
# Intersection
# =============================================================================


# Fractal iteration unroll granularity: a fully rolled fori_loop blocks XLA
# fusion (each of ~30 polynomial ops per iteration dispatches separately —
# the dominant cost of DE scenes on this backend), while a full unroll of
# `iterations` (25 in cornell.lua) at every estimator call site explodes
# compile time. Groups of 8 fuse well and keep graphs ~3x smaller.
_DE_UNROLL = 8


def _grouped_iterate(body, carry, iterations):
    """Apply ``body`` (index-insensitive) ``iterations`` times: full groups
    of _DE_UNROLL inside a fori_loop (each group body fuses), remainder
    unrolled."""
    groups, rest = divmod(iterations, _DE_UNROLL)
    if groups > 0:
        def group_body(_, c):
            for i in range(_DE_UNROLL):
                c = body(i, c)
            return c

        carry = jax.lax.fori_loop(0, groups, group_body, carry)
    for i in range(rest):
        carry = body(i, carry)
    return carry


def _de_distance(est: dict, p):
    """Distance estimator evaluation (shapes/distance_estimators.rs)."""
    if est["kind"] == "mandelbulb":
        iterations = est["iterations"]
        threshold = est["threshold"]
        power = est["power"]
        constant = est["constant"]
        dc = 1.0 if constant is None else 0.0

        def body(_, carry):
            z, r, dr, done = carry
            r_new = jnp.sqrt(jnp.maximum(geom.dot(z, z), 1e-30))
            done_now = done | (r_new > threshold)
            theta = jnp.arccos(jnp.clip(z[..., 2] / r_new, -1.0, 1.0))
            phi = jnp.arctan2(z[..., 1], z[..., 0])
            dr_new = r_new ** (power - 1.0) * power * dr + dc
            zr = r_new ** power
            theta = theta * power
            phi = phi * power
            z_new = (
                jnp.stack(
                    [
                        jnp.sin(theta) * jnp.cos(phi),
                        jnp.sin(phi) * jnp.sin(theta),
                        jnp.cos(theta),
                    ],
                    axis=-1,
                )
                * zr[..., None]
            )
            z_new = z_new + (jnp.asarray(constant) if constant is not None else p)
            keep = ~done_now
            return (
                jnp.where(keep[..., None], z_new, z),
                jnp.where(done, r, r_new),
                jnp.where(keep, dr_new, dr),
                done_now,
            )

        z0 = p
        r0 = jnp.zeros(p.shape[:-1])
        dr0 = jnp.ones(p.shape[:-1])
        done0 = jnp.zeros(p.shape[:-1], bool)
        z, r, dr, _ = _grouped_iterate(body, (z0, r0, dr0, done0), iterations)
        return 0.5 * jnp.log(jnp.maximum(r, 1e-30)) * r / dr

    # quaternion julia: z as (x, y, z, slice) quaternion (w=point coords!)
    iterations = est["iterations"]
    threshold = est["threshold"]
    constant = jnp.asarray(est["constant"])  # (x, y, z, w) from vector
    variant = est["variant"]

    # cgmath Quaternion::new(s, x, y, z): here z = Quat(point.x, point.y,
    # point.z, slice) means s=point.x, v=(point.y, point.z, slice).
    def to_quat(p):
        s = jnp.broadcast_to(jnp.asarray(est["slice_plane"]), p.shape[:-1])
        return jnp.concatenate([p, s[..., None]], axis=-1)  # (s=x, v=(y,z,w))

    def qmul(a, b):
        # quaternion with layout (s, vx, vy, vz) stored as (a0, a1, a2, a3)
        s1, x1, y1, z1 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
        s2, x2, y2, z2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
        return jnp.stack(
            [
                s1 * s2 - x1 * x2 - y1 * y2 - z1 * z2,
                s1 * x2 + x1 * s2 + y1 * z2 - z1 * y2,
                s1 * y2 - x1 * z2 + y1 * s2 + z1 * x2,
                s1 * z2 + x1 * y2 - y1 * x2 + z1 * s2,
            ],
            axis=-1,
        )

    def bicomplex_mul(a, b):
        x1, y1, z1, w1 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
        x2, y2, z2, w2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
        return jnp.stack(
            [
                x1 * x2 - y1 * y2 - z1 * z2 + w1 * w2,
                x1 * y2 + y1 * x2 - z1 * w2 - w1 * z2,
                x1 * z2 - y1 * w2 + z1 * x2 - w1 * y2,
                x1 * w2 + y1 * z2 + z1 * y2 + w1 * x2,
            ],
            axis=-1,
        )

    def qsq(q):
        # z*z for a quaternion commuting with itself: (s^2-|v|^2, 2s*v)
        s = q[..., 0]
        v2 = q[..., 1] ** 2 + q[..., 2] ** 2 + q[..., 3] ** 2
        s2 = s + s
        return jnp.stack(
            [s * s - v2, s2 * q[..., 1], s2 * q[..., 2], s2 * q[..., 3]],
            axis=-1,
        )

    def bsq(q):
        x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
        return jnp.stack(
            [
                x * x - y * y - z * z + w * w,
                2.0 * (x * y - z * w),
                2.0 * (x * z - y * w),
                2.0 * (x * w + y * z),
            ],
            axis=-1,
        )

    # shared square + re-associated derivative ((dz*z)*z = dz*z^2):
    # identical op order to kernels._de_step_julia so the kernel parity
    # test holds tight (chaotic orbits amplify ulp drift)
    if variant == "regular":
        pow_step = lambda z, dz: (qsq(z), qmul(dz, z) * 2.0)
    elif variant == "cubic":
        def pow_step(z, dz):
            q2 = qsq(z)
            return qmul(q2, z), qmul(dz, q2) * 3.0
    else:  # bicomplex
        def pow_step(z, dz):
            q2 = bsq(z)
            return q2, bicomplex_mul(dz, q2) * 2.0

    thr2 = float(threshold) * float(threshold)

    # constant comes from a Vector expression -> cgmath Quaternion via
    # Quaternion::new(x, y, z, w) = (s=x, v=(y, z, w)); same layout as to_quat.
    def body(_, carry):
        z, r2, dz, done = carry
        r2_new = geom.dot(z, z)
        done_now = done | (r2_new > thr2)
        zp, dz_new = pow_step(z, dz)
        z_new = zp + constant
        keep = ~done_now
        return (
            jnp.where(keep[..., None], z_new, z),
            jnp.where(done, r2, r2_new),
            jnp.where(keep[..., None], dz_new, dz),
            done_now,
        )

    z0 = to_quat(p)
    r0 = jnp.zeros(p.shape[:-1])
    dz0 = jnp.concatenate(
        [jnp.ones(p.shape[:-1] + (1,)), jnp.zeros(p.shape[:-1] + (3,))], axis=-1
    )
    done0 = jnp.zeros(p.shape[:-1], bool)
    z, r2, dz, _ = _grouped_iterate(body, (z0, r0, dz0, done0), iterations)
    r = jnp.sqrt(jnp.maximum(r2, 1e-30))
    dz_mag = jnp.sqrt(jnp.maximum(geom.dot(dz, dz), 1e-30))
    return 0.5 * jnp.log(jnp.maximum(r, 1e-30)) * r / dz_mag


def _intersect_de(shape, origin, direction, max_steps, t_cap=None):
    """Sphere tracing within a bounding volume (shapes/mod.rs:120-155).

    ``t_cap`` ([N], optional): march no further than this distance —
    occlusion queries pass the lamp distance, so lanes stop as soon as
    they pass the target instead of marching to the bounds exit (exact
    for shadows: a surface beyond the lamp cannot occlude it). It can
    only prune; where the bounds are small relative to lamp distances it
    rarely bites."""
    if shape.bounds_kind == "box":
        center = jnp.asarray((shape.bounds_a + shape.bounds_b) * 0.5)
        hit, tmin, tmax = geom.ray_aabb_range(
            origin, direction, jnp.asarray(shape.bounds_a), jnp.asarray(shape.bounds_b)
        )
    else:
        center = jnp.asarray(shape.bounds_a)
        hit, tmin, tmax = geom.ray_sphere_range(
            origin, direction, center, float(shape.bounds_b[0])
        )
    if t_cap is not None:
        tmax = jnp.minimum(tmax, t_cap)

    local_origin = origin - center
    total0 = jnp.where(hit, tmin, jnp.inf)

    from . import kernels

    if kernels.kernel_path() != "xla":
        # Triton sphere trace: each block of lanes marches in registers and
        # stops when its own lanes are done (the XLA loop below runs the
        # whole wavefront until its slowest lane converges)
        total, dist = kernels.march_de(
            shape.estimator, local_origin, direction, total0, tmax, hit,
            max_steps,
        )
    else:
        omega = kernels.de_omega()

        def eval_d(total):
            p = local_origin + direction * total[..., None]
            return _de_distance(shape.estimator, p)

        dist0 = jnp.full_like(total0, jnp.inf)
        if omega <= 1.0:
            def cond(carry):
                total, dist, steps = carry
                active = (total < tmax) & (dist >= DIST_EPSILON) & (steps < max_steps)
                return jnp.any(active & hit)

            # Masked march: lanes that finish keep their values.
            def body(carry):
                total, dist, steps = carry
                active = (total < tmax) & (dist >= DIST_EPSILON) & hit
                d = eval_d(total)
                return (
                    jnp.where(active, total + d, total),
                    jnp.where(active, d, dist),
                    steps + 1,
                )

            total, dist, _ = jax.lax.while_loop(
                cond, body, (total0, dist0, jnp.int32(0))
            )
        else:
            # Over-relaxed sphere trace, identical to the kernel's
            # scheme (kernels._make_march_kernel): step omega*d, revert
            # to the plain step when consecutive step spheres stop
            # overlapping; `dist` only tracks safe evaluations.
            def cond(carry):
                total, dist, s_prev, d_prev, steps = carry
                active = (total < tmax) & (dist >= DIST_EPSILON) & (steps < max_steps)
                return jnp.any(active & hit)

            def body(carry):
                total, dist, s_prev, d_prev, steps = carry
                active = (total < tmax) & (dist >= DIST_EPSILON) & hit
                d = eval_d(total)
                unsafe = s_prev > d_prev + d
                t_revert = total - s_prev + d_prev
                step = omega * d
                step = jnp.where(total + step > tmax, d, step)
                return (
                    jnp.where(
                        active,
                        jnp.where(unsafe, t_revert, total + step),
                        total,
                    ),
                    jnp.where(active & ~unsafe, d, dist),
                    jnp.where(active, jnp.where(unsafe, d_prev, step), s_prev),
                    jnp.where(active & ~unsafe, d, d_prev),
                    steps + 1,
                )

            total, dist, _, _, _ = jax.lax.while_loop(
                cond, body,
                (
                    total0, dist0, jnp.zeros_like(total0),
                    jnp.full_like(total0, 1e30), jnp.int32(0),
                ),
            )
    ok = hit & (total <= tmax)
    return ok, jnp.where(ok, total, jnp.inf), local_origin


# Below this, dense tests beat divergent traversal. Equal to
# scene.CLUSTER_THRESHOLD so every non-empty primitive set has a device path
# (scene.py guarantees use_clusters above the threshold) and the dense
# sweep's [lanes, prims, 3] intermediates stay HBM-safe.
BRUTE_FORCE_PRIMS = CLUSTER_THRESHOLD
_BRUTE_CHUNK = 256

# NEE flattening crossover (trace_direct): total flattened lanes at or below
# this ride the single [N*ls] mega-batch; above it the serial per-sample
# loop runs. The crossover is not yet swept on the H100.
NEE_FLATTEN_LANES = 262144


def _brute_force_triangles(scene, origin, direction, best):
    """Dense [rays x prims] triangle tests, chunked over primitives.

    On a vector machine a fully dense test sweep is far faster than a
    per-ray traversal loop for small scenes: it is pure VPU work with a
    min-reduction, no serial node walk."""
    a = scene.arrays
    count = scene.num_triangles
    for c0 in range(0, count, _BRUTE_CHUNK):
        c1 = min(c0 + _BRUTE_CHUNK, count)
        ok, t, u, v = geom.ray_triangle(
            origin[:, None, :],
            direction[:, None, :],
            a["tri_v0"][None, c0:c1],
            a["tri_e1"][None, c0:c1],
            a["tri_e2"][None, c0:c1],
        )
        t = jnp.where(ok, t, jnp.inf)
        # gather-free row-min selection: pick the first column achieving the
        # minimum via a masked sum instead of take_along_axis
        tj = jnp.min(t, axis=1)
        hitmin = t == tj[:, None]
        first = hitmin & (jnp.cumsum(hitmin, axis=1) == 1)
        pick = lambda arr: jnp.sum(jnp.where(first, arr, 0.0), axis=1)
        better = tj < best["t"]
        best = {
            "t": jnp.where(better, tj, best["t"]),
            "kind": jnp.where(better, KIND_TRIANGLE, best["kind"]),
            "idx": jnp.where(
                better,
                c0 + jnp.sum(jnp.where(first, jnp.arange(t.shape[1]), 0), axis=1).astype(jnp.int32),
                best["idx"],
            ),
            "u": jnp.where(better, pick(u), best["u"]),
            "v": jnp.where(better, pick(v), best["v"]),
        }
    return best


def _brute_force_spheres(scene, origin, direction, best):
    a = scene.arrays
    count = scene.num_spheres
    for c0 in range(0, count, _BRUTE_CHUNK):
        c1 = min(c0 + _BRUTE_CHUNK, count)
        ok, t = geom.ray_sphere(
            origin[:, None, :],
            direction[:, None, :],
            a["sph_center"][None, c0:c1],
            a["sph_radius"][None, c0:c1],
        )
        t = jnp.where(ok, t, jnp.inf)
        tj = jnp.min(t, axis=1)
        hitmin = t == tj[:, None]
        first = hitmin & (jnp.cumsum(hitmin, axis=1) == 1)
        better = tj < best["t"]
        best = {
            "t": jnp.where(better, tj, best["t"]),
            "kind": jnp.where(better, KIND_SPHERE, best["kind"]),
            "idx": jnp.where(
                better,
                c0 + jnp.sum(jnp.where(first, jnp.arange(t.shape[1]), 0), axis=1).astype(jnp.int32),
                best["idx"],
            ),
            "u": best["u"],
            "v": best["v"],
        }
    return best


def intersect_shadow(
    scene: Scene, origin, direction, cfg: TraceConfig,
    max_dist=None, block_below=None,
):
    """Occlusion-only query: nearest hit distance up to ``max_dist``.

    Cheaper than intersect_scene: no surface bookkeeping, just a running
    min-t over planes, primitives, and DE shapes. When ``max_dist`` ([N],
    the distance to the light) is given, the clustered traversal starts its
    best-t there so subtrees beyond the target are pruned, and unoccluded
    lanes return ``max_dist`` instead of inf (callers only compare against
    ``max_dist - epsilon``, so the semantics are unchanged). ``block_below``
    ([N]) is the caller's occlusion bound: a lane that finds any hit below
    it is definitively blocked and exits the traversal early."""
    n = origin.shape[0]
    a = scene.arrays
    t_best = jnp.full(n, jnp.inf) if max_dist is None else max_dist

    if scene.num_planes > 0:
        hit, t = geom.ray_plane(
            origin[:, None, :],
            direction[:, None, :],
            a["pla_normal"][None, :, :],
            a["pla_d"][None, :],
        )
        t_best = jnp.minimum(t_best, jnp.min(jnp.where(hit, t, jnp.inf), axis=1))

    if scene.use_clusters:
        t_state = _cluster_traverse(
            scene, origin, direction, {"t": t_best}, _cluster_leaf_shadow(scene),
            exit_below=block_below,
        )
        t_best = t_state["t"]
    elif 0 < scene.num_primitives <= BRUTE_FORCE_PRIMS:
        if scene.num_triangles > 0:
            for c0 in range(0, scene.num_triangles, _BRUTE_CHUNK):
                c1 = min(c0 + _BRUTE_CHUNK, scene.num_triangles)
                ok, t, _, _ = geom.ray_triangle(
                    origin[:, None, :],
                    direction[:, None, :],
                    a["tri_v0"][None, c0:c1],
                    a["tri_e1"][None, c0:c1],
                    a["tri_e2"][None, c0:c1],
                )
                t_best = jnp.minimum(
                    t_best, jnp.min(jnp.where(ok, t, jnp.inf), axis=1)
                )
        if scene.num_spheres > 0:
            for c0 in range(0, scene.num_spheres, _BRUTE_CHUNK):
                c1 = min(c0 + _BRUTE_CHUNK, scene.num_spheres)
                ok, t = geom.ray_sphere(
                    origin[:, None, :],
                    direction[:, None, :],
                    a["sph_center"][None, c0:c1],
                    a["sph_radius"][None, c0:c1],
                )
                t_best = jnp.minimum(
                    t_best, jnp.min(jnp.where(ok, t, jnp.inf), axis=1)
                )

    for shape in scene.de_shapes:
        ok, t, _ = _intersect_de(
            shape, origin, direction, cfg.max_de_steps, t_cap=max_dist
        )
        t_best = jnp.minimum(t_best, jnp.where(ok, t, jnp.inf))

    return t_best


def intersect_scene(scene: Scene, origin, direction, cfg: TraceConfig):
    """Closest hit for a ray batch. Returns a dict with t, kind, idx, u, v."""
    n = origin.shape[0]
    a = scene.arrays

    best = {
        "t": jnp.full(n, jnp.inf),
        "kind": jnp.full(n, KIND_NONE, jnp.int32),
        "idx": jnp.zeros(n, jnp.int32),
        "u": jnp.zeros(n),
        "v": jnp.zeros(n),
    }

    # planes: dense scan (they sit outside the BVH, world.rs:277-285)
    if scene.num_planes > 0:
        hit, t = geom.ray_plane(
            origin[:, None, :],
            direction[:, None, :],
            a["pla_normal"][None, :, :],
            a["pla_d"][None, :],
        )
        t = jnp.where(hit, t, jnp.inf)
        pi = jnp.argmin(t, axis=1)
        pt = jnp.take_along_axis(t, pi[:, None], axis=1)[:, 0]
        better = pt < best["t"]
        best["t"] = jnp.where(better, pt, best["t"])
        best["kind"] = jnp.where(better, KIND_PLANE, best["kind"])
        best["idx"] = jnp.where(better, pi.astype(jnp.int32), best["idx"])

    # finite primitives: clustered BVH for large scenes, dense sweep for
    # small ones (never a per-ray while_loop walk; scene.py guarantees one
    # of these two paths covers any non-empty primitive set)
    if scene.use_clusters:
        best = _cluster_traverse(
            scene, origin, direction, best, _cluster_leaf_closest(scene)
        )
    elif 0 < scene.num_primitives <= BRUTE_FORCE_PRIMS:
        if scene.num_triangles > 0:
            best = _brute_force_triangles(scene, origin, direction, best)
        if scene.num_spheres > 0:
            best = _brute_force_spheres(scene, origin, direction, best)

    # distance-estimated shapes (few per scene; marched outside the BVH)
    for j, shape in enumerate(scene.de_shapes):
        ok, t, _ = _intersect_de(shape, origin, direction, cfg.max_de_steps)
        better = ok & (t > DIST_EPSILON) & (t < best["t"])
        best["t"] = jnp.where(better, t, best["t"])
        best["kind"] = jnp.where(better, KIND_DE, best["kind"])
        best["idx"] = jnp.where(better, j, best["idx"])

    return best


def intersect_merged(scene: Scene, origin, direction, cfg: TraceConfig, t_seed, exit_below, is_shadow):
    """Closest-hit batch with per-lane initial t and per-lane any-hit exit:
    lets a deferred bounce run its NEE shadow batch and the NEXT bounce's
    extension rays through ONE cluster traversal (each outer walk iteration
    has a mostly fixed launch cost, so folding the two serial traversals
    per bounce into one saves ~the shorter walk).

    Per lane: shadow lanes seed ``t_seed`` at the lamp distance (subtree
    pruning, intersect_shadow semantics) and ``exit_below`` at their
    definitive-blocker bound; extension lanes seed inf / -inf; inert lanes
    (dead, or masked-off shadow samples) seed t_seed=0 so the root slab test
    rejects every subtree and the lane never parks. ``is_shadow`` selects
    intersect_shadow's epsilon rule for DE shapes (it counts hits at any
    t >= 0; the closest-hit rule skips t <= DIST_EPSILON). Cluster scenes
    only (scene.use_clusters)."""
    n = origin.shape[0]
    a = scene.arrays

    best = {
        "t": t_seed,
        "kind": jnp.full(n, KIND_NONE, jnp.int32),
        "idx": jnp.zeros(n, jnp.int32),
        "u": jnp.zeros(n),
        "v": jnp.zeros(n),
    }

    if scene.num_planes > 0:
        hit, t = geom.ray_plane(
            origin[:, None, :],
            direction[:, None, :],
            a["pla_normal"][None, :, :],
            a["pla_d"][None, :],
        )
        t = jnp.where(hit, t, jnp.inf)
        pi = jnp.argmin(t, axis=1)
        pt = jnp.take_along_axis(t, pi[:, None], axis=1)[:, 0]
        better = pt < best["t"]
        best["t"] = jnp.where(better, pt, best["t"])
        best["kind"] = jnp.where(better, KIND_PLANE, best["kind"])
        best["idx"] = jnp.where(better, pi.astype(jnp.int32), best["idx"])

    if scene.use_clusters:
        best = _cluster_traverse(
            scene, origin, direction, best, _cluster_leaf_closest(scene),
            exit_below=exit_below,
        )

    for j, shape in enumerate(scene.de_shapes):
        ok, t, _ = _intersect_de(shape, origin, direction, cfg.max_de_steps)
        better = ok & ((t > DIST_EPSILON) | is_shadow) & (t < best["t"])
        best["t"] = jnp.where(better, t, best["t"])
        best["kind"] = jnp.where(better, KIND_DE, best["kind"])
        best["idx"] = jnp.where(better, j, best["idx"])

    return best


def surface_data(scene: Scene, hit, origin, direction, cfg: TraceConfig):
    """Gather per-hit surface attributes, branchless across hit kinds.

    Returns (position, normal, frame_quat, uv, material_id)."""
    a = scene.arrays
    t = hit["t"]
    safe_t = jnp.where(jnp.isfinite(t), t, 0.0)
    position = origin + direction * safe_t[:, None]
    kind = hit["kind"]
    idx = hit["idx"]

    n = origin.shape[0]
    normal = jnp.zeros((n, 3))
    quat = jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0, 0.0]), (n, 4))
    uv = jnp.zeros((n, 2))
    mat = jnp.zeros(n, jnp.int32)

    # triangles
    u = hit["u"][:, None]
    v = hit["v"][:, None]
    w = 1.0 - hit["u"] - hit["v"]
    tn = a["tri_n"][idx]  # [N, 3, 3]
    tq = a["tri_q"][idx]  # [N, 3, 4]
    tuv = a["tri_uv"][idx]  # [N, 3, 2]
    tri_normal = geom.normalize(tn[:, 0] * w[:, None] + tn[:, 1] * u + tn[:, 2] * v)
    tri_quat = geom.quat_normalize(tq[:, 0] * w[:, None] + tq[:, 1] * u + tq[:, 2] * v)
    tri_uv_i = tuv[:, 0] * w[:, None] + tuv[:, 1] * u + tuv[:, 2] * v
    is_tri = (kind == KIND_TRIANGLE)[:, None]
    normal = jnp.where(is_tri, tri_normal, normal)
    quat = jnp.where(is_tri, tri_quat, quat)
    uv = jnp.where(is_tri, tri_uv_i, uv)
    mat = jnp.where(kind == KIND_TRIANGLE, a["tri_mat"][idx], mat)

    # spheres
    s_center = a["sph_center"][idx]
    s_scale = a["sph_texscale"][idx]
    sph_normal, sph_quat, sph_uv = geom.sphere_surface_frame(position, s_center, s_scale)
    is_sph = (kind == KIND_SPHERE)[:, None]
    normal = jnp.where(is_sph, sph_normal, normal)
    quat = jnp.where(is_sph, sph_quat, quat)
    uv = jnp.where(is_sph, sph_uv, uv)
    mat = jnp.where(kind == KIND_SPHERE, a["sph_mat"][idx], mat)

    # planes
    p_norm = a["pla_normal"][idx]
    p_quat = a["pla_quat"][idx]
    p_uv = geom.plane_uv(position, p_quat, a["pla_texscale"][idx])
    is_pla = (kind == KIND_PLANE)[:, None]
    normal = jnp.where(is_pla, p_norm, normal)
    quat = jnp.where(is_pla, p_quat, quat)
    uv = jnp.where(is_pla, p_uv, uv)
    mat = jnp.where(kind == KIND_PLANE, a["pla_mat"][idx], mat)

    # distance-estimated shapes: central-difference normals
    for j, shape in enumerate(scene.de_shapes):
        sel = kind == KIND_DE
        sel &= idx == j
        if shape.bounds_kind == "box":
            center = jnp.asarray((shape.bounds_a + shape.bounds_b) * 0.5)
        else:
            center = jnp.asarray(shape.bounds_a)
        # offset position just off the surface (shapes/mod.rs:138)
        local = (origin - center) + direction * (safe_t - DIST_EPSILON)[:, None]
        eps = DIST_EPSILON

        # all six central-difference probes in ONE estimator eval (the
        # estimator graph is large — six separate inlines exploded compile)
        n_lanes = local.shape[0]
        offsets = jnp.concatenate(
            [
                jnp.eye(3, dtype=local.dtype) * eps,
                -jnp.eye(3, dtype=local.dtype) * eps,
            ],
            axis=0,
        )  # [6, 3]
        probes = (local[None, :, :] + offsets[:, None, :]).reshape(6 * n_lanes, 3)
        d6 = _de_distance(shape.estimator, probes).reshape(6, n_lanes)
        de_n = geom.normalize(
            jnp.stack([d6[0] - d6[3], d6[1] - d6[4], d6[2] - d6[5]], axis=-1)
        )
        de_q = geom.de_normal_quat(de_n)
        normal = jnp.where(sel[:, None], de_n, normal)
        quat = jnp.where(sel[:, None], de_q, quat)
        mat = jnp.where(sel, shape.material_id, mat)

    return position, normal, quat, uv, mat


# =============================================================================
# Program banks
# =============================================================================


# NOTE: a per-launch cache of lambda-only program values ("evaluate each
# spectrum-curve program once before the bounce while_loop, reuse as a loop
# invariant") lost on the first backend despite cutting jaxpr eqns ~30%:
# XLA fuses the elementwise program evaluations into their consumers;
# materializing them as [N, S] while-loop invariants costs real HBM traffic
# every iteration and breaks fusion. Recompute-in-fusion beats memoized
# buffers for elementwise chains; jaxpr eqn count is not a proxy for
# post-fusion op count.


def _bank_table_eval(table, span, prog_id, wavelength):
    """Linear interpolation of the baked [P, G] bank table at each lane's
    wavelengths: one flat gather pair + lerp regardless of how many programs
    the scene has (scene.bake_bank_tables)."""
    g = table.shape[1]
    lo, hi = span
    pos = jnp.clip((wavelength - lo) * ((g - 1) / (hi - lo)), 0.0, g - 1.0)
    i0 = jnp.minimum(pos.astype(jnp.int32), g - 2)
    frac = pos - i0.astype(jnp.float32)
    base = jnp.maximum(prog_id, 0)[:, None] * g + i0
    flat = table.reshape(-1)
    v0 = flat[base]
    v1 = flat[base + 1]
    return v0 + (v1 - v0) * frac


def eval_color_bank(scene: Scene, prog_id, inputs: ProgramInputs, active=None):
    """Evaluate per-ray color programs: out[i] = program[prog_id[i]](inputs).

    Lambda-only programs ride the baked bank table when the scene has many
    (one gather instead of an O(P) masked loop — the reference evaluates the
    hit material's program per thread, execution_context.rs, so its cost
    never scales with the program count); uv/normal-dependent programs
    (textures, fresnel) always evaluate exactly via the loop."""
    out = jnp.zeros(inputs.wavelength.shape)
    baked = scene.color_bank_bakeable
    if baked is not None:
        val = _bank_table_eval(
            scene.arrays["color_bank"], scene.bank_span, prog_id,
            inputs.wavelength,
        )
        in_table = jnp.asarray(np.asarray(baked))[jnp.maximum(prog_id, 0)]
        mask = in_table & (prog_id >= 0)
        if active is not None:
            mask &= active
        out = out + jnp.where(mask[:, None], val, 0.0)
    for p, prog in enumerate(scene.color_programs):
        if baked is not None and baked[p]:
            continue
        mask = prog_id == p
        if active is not None:
            mask &= active
        val = prog(inputs)
        out = out + jnp.where(mask[:, None], jnp.broadcast_to(val, out.shape), 0.0)
    return out


def eval_prob_bank(scene: Scene, prog_id, inputs: ProgramInputs, active=None):
    """Evaluate per-ray probability programs at the hero wavelength -> [N]."""
    n = inputs.wavelength.shape[0]
    out = jnp.ones(n)  # missing program (-1) means probability 1
    hero_inputs = ProgramInputs(
        wavelength=inputs.wavelength[:, :1],
        normal=inputs.normal,
        incident=inputs.incident,
        uv=inputs.uv,
    )
    baked = scene.prob_bank_bakeable
    if baked is not None:
        val = _bank_table_eval(
            scene.arrays["prob_bank"], scene.bank_span, prog_id,
            hero_inputs.wavelength,
        )[:, 0]
        mask = jnp.asarray(np.asarray(baked))[jnp.maximum(prog_id, 0)]
        mask &= prog_id >= 0
        if active is not None:
            mask &= active
        out = jnp.where(mask, val, out)
    for p, prog in enumerate(scene.prob_programs):
        if baked is not None and baked[p]:
            continue
        mask = prog_id == p
        if active is not None:
            mask &= active
        val = prog(hero_inputs)
        val = jnp.broadcast_to(val, (n, 1))[:, 0]
        out = jnp.where(mask, val, out)
    return out


def apply_normal_maps(scene: Scene, mat_id, normal, quat, inputs: ProgramInputs):
    """Material normal mapping (materials/mod.rs:68-81)."""
    if not scene.normal_programs:
        return normal
    prog_id = scene.arrays["mat_normal_prog"][mat_id]
    out = normal
    for p, prog in enumerate(scene.normal_programs):
        mask = (prog_id == p)[:, None]
        vec = prog(inputs)  # [N, 4], [N, 1, 4], or scalar-broadcastable
        # normal maps cannot read the wavelength (the reference rejects such
        # programs at compile time, tracer.rs:60-70), so drop the lambda axis
        if getattr(vec, "ndim", 0) == 3:
            vec = vec[:, 0, :]
        vec = jnp.broadcast_to(vec, (normal.shape[0], 4))[:, :3]
        mapped = geom.normalize(geom.quat_rotate(quat, vec))
        degenerate = geom.dot(vec, vec) < 1e-12
        out = jnp.where(mask & ~degenerate[:, None], mapped, out)
    return out


# =============================================================================
# BSDF scattering (materials/{diffuse,mirror,refractive}.rs)
# =============================================================================


def scatter(scene: Scene, comp_idx, direction, normal, hero_wl, u):
    """Branchless scatter across all BSDF types.

    ``u``: [N, 3] uniforms. Returns dict with out_dir, probability, dispersed,
    is_specular, is_diffuse, is_emissive."""
    a = scene.arrays
    bsdf = a["comp_bsdf"][comp_idx]

    d_dot_n = geom.dot(direction, normal)
    flipped = jnp.where((d_dot_n < 0.0)[:, None], normal, -normal)

    # diffuse
    diff_out = geom.sample_hemisphere(u[:, 0], u[:, 1], flipped)

    # mirror
    mirror_out = direction - flipped * (2.0 * geom.dot(direction, flipped))[:, None]

    # refractive (refractive.rs:46-91); wavelength in micrometres for Cauchy
    wl = hero_wl * 0.001
    ior = a["comp_ior"][comp_idx] + a["comp_disp"][comp_idx] / (wl * wl)
    env_ior = a["comp_env_ior"][comp_idx] + a["comp_env_disp"][comp_idx] / (wl * wl)
    refr_dispersed = (a["comp_disp"][comp_idx] != 0.0) | (
        a["comp_env_disp"][comp_idx] != 0.0
    )

    nl = flipped
    n_dot_d = geom.dot(normal, direction)
    reflected = direction - normal * (2.0 * n_dot_d)[:, None]
    into = geom.dot(normal, nl) > 0.0
    nnt = jnp.where(into, env_ior / ior, ior / env_ior)
    ddn = geom.dot(direction, nl)
    cos2t = 1.0 - nnt * nnt * (1.0 - ddn * ddn)
    tir = cos2t < 0.0
    s_sign = jnp.where(into, 1.0, -1.0)
    s_val = s_sign * (ddn * nnt + jnp.sqrt(jnp.maximum(cos2t, 0.0)))
    tdir = geom.normalize(direction * nnt[:, None] - normal * s_val[:, None])
    a_ = ior - env_ior
    b_ = ior + env_ior
    r0 = (a_ * a_) / (b_ * b_)
    c_ = 1.0 - jnp.where(into, -ddn, geom.dot(tdir, normal))
    re = r0 + (1.0 - r0) * c_ ** 5
    tr = 1.0 - re
    p_refl = 0.25 + 0.5 * re
    pick_reflect = u[:, 2] < p_refl
    refr_out = jnp.where(
        (tir | pick_reflect)[:, None], reflected, tdir
    )
    refr_prob = jnp.where(
        tir, 1.0, jnp.where(pick_reflect, re / p_refl, tr / (1.0 - p_refl))
    )

    is_diffuse = bsdf == BSDF_DIFFUSE
    is_mirror = bsdf == BSDF_MIRROR
    is_refr = bsdf == BSDF_REFRACTIVE
    is_emissive = bsdf == BSDF_EMISSIVE

    out_dir = jnp.where(
        is_diffuse[:, None],
        diff_out,
        jnp.where(is_mirror[:, None], mirror_out, refr_out),
    )
    probability = jnp.where(is_refr, refr_prob, 1.0)
    dispersed = is_refr & refr_dispersed
    is_specular = is_mirror | is_refr

    return {
        "out_dir": out_dir,
        "probability": probability,
        "dispersed": dispersed,
        "is_specular": is_specular,
        "is_diffuse": is_diffuse,
        "is_emissive": is_emissive,
    }


def brdf_value(normal, out_dir, is_diffuse):
    """Lambertian 2|n.out| for diffuse bounces, 1 for specular
    (diffuse.rs:27-29, tracer.rs:176-182)."""
    return jnp.where(is_diffuse, 2.0 * jnp.abs(geom.dot(normal, out_dir)), 1.0)


# =============================================================================
# Next-event estimation (tracer.rs:347-442) and lamp sampling (lamp.rs:23-82)
# =============================================================================


def _triangle_area(e1, e2):
    c = jnp.cross(e1, e2)
    return 0.5 * jnp.sqrt(jnp.maximum(geom.dot(c, c), 0.0))


def sample_lamp(scene: Scene, lamp_idx, target, u):
    """Sample one lamp toward ``target`` (lamp.rs:23-82), branchless over
    the lamp types present in the scene. ``u``: [N, 4] uniforms.

    Returns dict: direction, sq_distance (inf when directional), weight,
    has_physical_surface, surface normal/uv, surface material id (for
    physical lamps), color program id (for color lamps)."""
    a = scene.arrays
    ltype = a["lamp_type"][lamp_idx]
    lvec = a["lamp_vec"][lamp_idx]
    lwidth = a["lamp_width"][lamp_idx]
    n = target.shape[0]

    zero3 = jnp.zeros((n, 3))
    zero = jnp.zeros(n)
    direction = zero3
    sq_distance = jnp.full(n, jnp.inf)
    weight = jnp.ones(n)
    surf_normal = zero3
    surf_uv = jnp.zeros((n, 2))
    surf_mat = jnp.zeros(n, jnp.int32)

    is_dir = ltype == LAMP_DIRECTIONAL
    is_pt = ltype == LAMP_POINT
    is_sph = ltype == LAMP_SPHERE
    is_tri = ltype == LAMP_TRIANGLE
    is_shape = is_sph | is_tri

    if LAMP_DIRECTIONAL in scene.lamp_types:
        dir_dir = jnp.where(
            (lwidth > 0.0)[:, None],
            geom.sample_cone(u[:, 0], u[:, 1], lvec, lwidth),
            lvec,
        )
        direction = jnp.where(is_dir[:, None], dir_dir, direction)

    if LAMP_POINT in scene.lamp_types:
        v_pt = lvec - target
        pt_sqd = geom.dot(v_pt, v_pt)
        pt_dir = geom.normalize(v_pt)
        pt_weight = 4.0 * jnp.pi / jnp.maximum(pt_sqd, 1e-20)
        direction = jnp.where(is_pt[:, None], pt_dir, direction)
        sq_distance = jnp.where(is_pt, pt_sqd, sq_distance)
        weight = jnp.where(is_pt, pt_weight, weight)

    ref = jnp.maximum(a["lamp_ref"][lamp_idx], 0)

    if LAMP_SPHERE in scene.lamp_types:
        # sphere shape (shapes/mod.rs:209-271)
        s_center = a["sph_center"][ref]
        s_radius_full = a["sph_radius"][ref]
        s_radius = jnp.maximum(s_radius_full - DIST_EPSILON, 0.0)
        dir_to_c = s_center - target
        dist2 = geom.dot(dir_to_c, dir_to_c)
        outside = dist2 > s_radius * s_radius
        cos_theta_max = jnp.sqrt(
            jnp.maximum(1.0 - (s_radius * s_radius) / jnp.maximum(dist2, 1e-20), 0.0)
        )
        cone_dir = geom.sample_cone(
            u[:, 0], u[:, 1], geom.normalize(dir_to_c), cos_theta_max
        )
        # the cone is computed from the epsilon-reduced radius but the sample
        # point comes from intersecting the FULL sphere (shapes/mod.rs:209-238
        # shadows only the local radius), so shadow rays that re-hit the lamp
        # land at the same distance and pass the occlusion test
        cone_hit, cone_t = geom.ray_sphere(target, cone_dir, s_center, s_radius_full)
        cone_t = jnp.where(cone_hit, cone_t, 0.0)  # the reference's "cheat" fallback
        sph_point_out = target + cone_dir * cone_t[:, None]
        # inside: uniform surface point (full radius)
        unit = geom.sample_sphere(u[:, 0], u[:, 1])
        sph_point_in = s_center + unit * s_radius_full[:, None]
        sph_point = jnp.where(outside[:, None], sph_point_out, sph_point_in)
        sph_v = sph_point - target
        sph_sqd_in = geom.dot(sph_v, sph_v)
        sph_sqd = jnp.where(outside, cone_t * cone_t, sph_sqd_in)
        sph_dir = jnp.where(outside[:, None], cone_dir, geom.normalize(sph_v))
        # solid_angle_towards uses the full radius (shapes/mod.rs:253-271)
        cos_full = jnp.sqrt(
            jnp.maximum(
                1.0 - (s_radius_full * s_radius_full) / jnp.maximum(dist2, 1e-20), 0.0
            )
        )
        sph_normal, _, sph_uv = geom.sphere_surface_frame(
            sph_point, s_center, a["sph_texscale"][ref]
        )
        sph_area = s_radius_full * s_radius_full * 4.0 * jnp.pi
        cos_in_sph = jnp.abs(geom.dot(sph_normal, -sph_dir))
        sph_weight = jnp.where(
            dist2 > s_radius_full * s_radius_full,
            geom.solid_angle(cos_full),
            cos_in_sph * sph_area / jnp.maximum(sph_sqd, 1e-20),
        )
        direction = jnp.where(is_sph[:, None], sph_dir, direction)
        sq_distance = jnp.where(is_sph, sph_sqd, sq_distance)
        weight = jnp.where(is_sph, sph_weight, weight)
        surf_normal = jnp.where(is_sph[:, None], sph_normal, surf_normal)
        surf_uv = jnp.where(is_sph[:, None], sph_uv, surf_uv)
        surf_mat = jnp.where(is_sph, a["sph_mat"][ref], surf_mat)

    if LAMP_TRIANGLE in scene.lamp_types:
        # triangle shape: uniform point (shapes/mod.rs:180-207)
        t_v0 = a["tri_v0"][ref]
        t_e1 = a["tri_e1"][ref]
        t_e2 = a["tri_e2"][ref]
        tu = u[:, 0]
        tv = u[:, 1]
        fold = tu + tv > 1.0
        tu = jnp.where(fold, 1.0 - tu, tu)
        tv = jnp.where(fold, 1.0 - tv, tv)
        tri_point = t_v0 + t_e1 * tu[:, None] + t_e2 * tv[:, None]
        tri_v = tri_point - target
        tri_sqd = geom.dot(tri_v, tri_v)
        tri_dir = geom.normalize(tri_v)
        tw = 1.0 - tu - tv
        tn = a["tri_n"][ref]
        tq_uv = a["tri_uv"][ref]
        tri_normal = geom.normalize(
            tn[:, 0] * tw[:, None] + tn[:, 1] * tu[:, None] + tn[:, 2] * tv[:, None]
        )
        tri_uv_i = (
            tq_uv[:, 0] * tw[:, None]
            + tq_uv[:, 1] * tu[:, None]
            + tq_uv[:, 2] * tv[:, None]
        )
        tri_area = _triangle_area(t_e1, t_e2)
        cos_in_tri = jnp.abs(geom.dot(tri_normal, -tri_dir))
        tri_weight = cos_in_tri * tri_area / jnp.maximum(tri_sqd, 1e-20)
        direction = jnp.where(is_tri[:, None], tri_dir, direction)
        sq_distance = jnp.where(is_tri, tri_sqd, sq_distance)
        weight = jnp.where(is_tri, tri_weight, weight)
        surf_normal = jnp.where(is_tri[:, None], tri_normal, surf_normal)
        surf_uv = jnp.where(is_tri[:, None], tri_uv_i, surf_uv)
        surf_mat = jnp.where(is_tri, a["tri_mat"][ref], surf_mat)

    return {
        "direction": direction,
        "sq_distance": sq_distance,
        "weight": weight,
        "is_shape": is_shape,
        "is_directional": is_dir,
        "surf_normal": surf_normal,
        "surf_uv": surf_uv,
        "surf_mat": surf_mat,
        "color_prog": a["lamp_color"][lamp_idx],
    }


def choose_emissive(scene: Scene, mat_id, u):
    """Uniformly pick an emissive component of a material
    (materials/mod.rs:56-62). Returns (component index, selection comp)."""
    a = scene.arrays
    count = jnp.maximum(a["mat_emis_count"][mat_id], 1)
    pick = jnp.minimum((u * count).astype(jnp.int32), count - 1)
    eidx = a["mat_emis_offset"][mat_id] + pick
    return a["emis_comp"][eidx], a["emis_selection"][eidx]


def trace_direct(
    scene: Scene,
    cfg: TraceConfig,
    key,
    active,
    position,
    normal,
    ray_in,
    wavelengths,
    reflectance,
    aux_alive,
):
    """Direct-light (NEE) contribution for the current bounce.

    Returns brightness delta [N, S]. ``reflectance`` is the throughput
    *after* the surface color multiply, matching contribute()'s ordering.

    Width-adaptive batching: narrow wavefronts (pooled flush chunks, tails)
    flatten all ``light_samples`` into ONE [N*ls] batch so the shadow query
    runs once per bounce instead of ls serial times; wide wavefronts keep
    the serial per-sample loop (NEE_FLATTEN_LANES). Both paths use identical PRNG draws (k_s = fold_in(key, s)), so results
    are bit-identical. Reference semantics: tracer.rs:362-399."""
    n = position.shape[0]
    s_count = reflectance.shape[1]
    delta = jnp.zeros_like(reflectance)
    if scene.num_lamps == 0 or cfg.light_samples == 0:
        return delta
    ls = cfg.light_samples

    k_pick, key = jax.random.split(key)
    lamp_idx = jax.random.randint(k_pick, (n,), 0, scene.num_lamps)
    pick_prob = 1.0 / scene.num_lamps
    probability = 1.0 / (ls * 2.0 * jnp.pi * pick_prob)

    flip = jnp.where((geom.dot(ray_in, normal) < 0.0)[:, None], normal, -normal)

    if n * ls > NEE_FLATTEN_LANES:
        # wide wavefront: serial per-sample loop (each pass is already far
        # above the dispatch floor; flattening would cross the slow-gather
        # width and lose ~5x)
        for s in range(ls):
            k_s = jax.random.fold_in(key, s)
            u = jax.random.uniform(k_s, (n, 4))
            u_emis = jax.random.uniform(jax.random.fold_in(k_s, 1), (n,))
            delta = delta + _direct_sample(
                scene, cfg, probability, active, position, flip,
                wavelengths, reflectance, aux_alive, lamp_idx, u, u_emis,
            )
        return delta

    # narrow wavefront: stack the identical per-sample draws into the
    # [ls*N] mega-batch and run every stage once
    u = jnp.concatenate(
        [jax.random.uniform(jax.random.fold_in(key, s), (n, 4)) for s in range(ls)],
        axis=0,
    )
    u_emis = jnp.concatenate(
        [
            jax.random.uniform(jax.random.fold_in(jax.random.fold_in(key, s), 1), (n,))
            for s in range(ls)
        ],
        axis=0,
    )

    tile = lambda x: jnp.concatenate([x] * ls, axis=0)
    contrib = _direct_sample(
        scene, cfg, probability, tile(active), tile(position), tile(flip),
        tile(wavelengths), tile(reflectance), tile(aux_alive),
        tile(lamp_idx), u, u_emis,
    )
    return delta + jnp.sum(contrib.reshape(ls, n, s_count), axis=0)


def trace_direct_pre(
    scene: Scene,
    cfg: TraceConfig,
    key,
    active,
    position,
    normal,
    ray_in,
    wavelengths,
    reflectance,
    aux_alive,
):
    """Phase A of a fully flattened NEE bounce: all ``light_samples`` stacked
    into one [ls*N] candidate batch whose shadow query the caller batches
    with other rays (the deferred cluster scheduler merges it with the next
    bounce's extension rays into ONE traversal launch — intersect_merged).
    PRNG draws are identical to trace_direct's flattened branch, so
    pre + shadow + trace_direct_post composes to the same estimator.
    Returns (query, pending) or None when the scene has no NEE work."""
    n = position.shape[0]
    if scene.num_lamps == 0 or cfg.light_samples == 0:
        return None
    ls = cfg.light_samples

    k_pick, key = jax.random.split(key)
    lamp_idx = jax.random.randint(k_pick, (n,), 0, scene.num_lamps)
    pick_prob = 1.0 / scene.num_lamps
    probability = 1.0 / (ls * 2.0 * jnp.pi * pick_prob)

    flip = jnp.where((geom.dot(ray_in, normal) < 0.0)[:, None], normal, -normal)

    u = jnp.concatenate(
        [jax.random.uniform(jax.random.fold_in(key, s), (n, 4)) for s in range(ls)],
        axis=0,
    )
    u_emis = jnp.concatenate(
        [
            jax.random.uniform(jax.random.fold_in(jax.random.fold_in(key, s), 1), (n,))
            for s in range(ls)
        ],
        axis=0,
    )
    tile = lambda x: jnp.concatenate([x] * ls, axis=0)
    return _direct_sample_pre(
        scene, cfg, probability, tile(active), tile(position), tile(flip),
        tile(wavelengths), tile(reflectance), tile(aux_alive),
        tile(lamp_idx), u, u_emis,
    )


def trace_direct_post(pending, t_hit, n, s_count):
    """Phase B of a flattened NEE bounce: occlusion verdicts -> per-lane
    brightness delta [N, S] (sum over the ls sample slots)."""
    contrib = _direct_sample_post(pending, t_hit)
    ls = contrib.shape[0] // n
    return jnp.sum(contrib.reshape(ls, n, s_count), axis=0)


def _direct_sample(
    scene, cfg, probability, active, position_f, flip_f, wavelengths_f,
    reflectance_f, aux_alive_f, lamp_idx_f, u, u_emis,
):
    """One NEE sample batch at arbitrary width: lamp sample -> shadow ->
    emissive component -> program banks -> masked contribution [W, S]."""
    query, pending = _direct_sample_pre(
        scene, cfg, probability, active, position_f, flip_f, wavelengths_f,
        reflectance_f, aux_alive_f, lamp_idx_f, u, u_emis,
    )
    t_hit = intersect_shadow(
        scene, query["origin"], query["direction"], cfg,
        max_dist=query["max_dist"], block_below=query["block_below"],
    )
    return _direct_sample_post(pending, t_hit)


def _direct_sample_pre(
    scene, cfg, probability, active, position_f, flip_f, wavelengths_f,
    reflectance_f, aux_alive_f, lamp_idx_f, u, u_emis,
):
    """Phase A of one NEE sample batch: lamp sampling, emissive component
    choice, program banks, and the candidate contribution — everything
    except the occlusion verdict. Returns (shadow query, pending): the
    caller runs the shadow query however it likes (stand-alone
    intersect_shadow, or batched with the next bounce's extension rays in
    the deferred cluster scheduler) and applies the verdict with
    _direct_sample_post. The bank evals here use the pre-occlusion mask
    (a superset of the final one); blocked lanes are zeroed in post, so the
    composed result is bit-identical to evaluating after the shadow test
    (`active` only gates which lanes' values are *kept*, never the values
    themselves — eval_color_bank/eval_prob_bank)."""
    w = position_f.shape[0]
    s_count = reflectance_f.shape[1]
    samp = sample_lamp(scene, lamp_idx_f, position_f, u)

    cos_out = jnp.maximum(geom.dot(flip_f, samp["direction"]), 0.0)
    contributes = active & (cos_out > 0.0)

    # shadow rays, pruned at the lamp distance with any-hit early exit
    # below the caller's own occlusion bound
    lamp_dist = jnp.sqrt(samp["sq_distance"])
    block_below = jnp.sqrt(jnp.maximum(samp["sq_distance"] - DIST_EPSILON, 0.0))

    # emissive surface sampling on physical lamps
    e_comp, e_sel = choose_emissive(scene, samp["surf_mat"], u_emis)
    target_normal = jnp.where(
        samp["is_shape"][:, None], samp["surf_normal"], -samp["direction"]
    )
    prob_inputs = ProgramInputs(
        wavelength=wavelengths_f,
        normal=target_normal,
        incident=samp["direction"],
        uv=samp["surf_uv"],
    )
    mat_prob = eval_prob_bank(
        scene, scene.arrays["comp_prob"][e_comp], prob_inputs, active=contributes
    ) * e_sel
    mat_prob = jnp.where(samp["is_shape"], mat_prob, 1.0)
    l_dispersed = jnp.where(
        samp["is_shape"], scene.arrays["comp_prob_uses_wl"][e_comp], False
    )

    color_prog = jnp.where(
        samp["is_shape"], scene.arrays["comp_color"][e_comp], samp["color_prog"]
    )
    l_color = eval_color_bank(scene, color_prog, prob_inputs, active=contributes)

    brdf = 2.0 * jnp.abs(geom.dot(flip_f, samp["direction"]))
    scale = samp["weight"] * probability * brdf
    l_prob = scale * mat_prob

    contrib = l_color * l_prob[:, None] * reflectance_f
    # hero always contributes; auxiliaries only while alive and when the
    # lamp's material probability didn't read the wavelength
    col_mask = jnp.concatenate(
        [
            jnp.ones((w, 1), bool),
            jnp.broadcast_to(
                (aux_alive_f & ~l_dispersed)[:, None],
                (w, s_count - 1),
            ),
        ],
        axis=1,
    )
    query = {
        "origin": position_f,
        "direction": samp["direction"],
        "max_dist": lamp_dist,
        "block_below": block_below,
        "contributes": contributes,
    }
    pending = {
        "contrib": contrib,
        "contributes": contributes,
        "col_mask": col_mask,
        "sq_distance": samp["sq_distance"],
    }
    return query, pending


def _direct_sample_post(pending, t_hit):
    """Phase B of one NEE sample batch: apply the occlusion verdict
    (t_hit from the shadow query seeded at the lamp distance) to the
    candidate contribution."""
    has_hit = jnp.isfinite(t_hit)
    hit_sq = jnp.where(has_hit, t_hit * t_hit, jnp.inf)
    blocked = jnp.where(
        jnp.isinf(pending["sq_distance"]),
        has_hit,
        has_hit & (hit_sq < pending["sq_distance"] - DIST_EPSILON),
    )
    ok = pending["contributes"] & ~blocked
    return jnp.where(ok[:, None] & pending["col_mask"], pending["contrib"], 0.0)


# =============================================================================
# The fused simple-renderer bounce loop (simple.rs + algorithm.rs, streaming)
# =============================================================================


# Compaction-ladder knobs (trace_paths): after LADDER_HEAD full-width
# bounces, survivors are stream-compacted to the front and the remaining
# bounces run over LADDER_DIV width-1/DIV chunks, each a while_loop with
# whole-batch early exit; a lax.cond falls back to the full-width tail when
# more than 5/8 of lanes survive the head (enclosed scenes like cornell).
#
# DEFAULT OFF (LADDER_DIV=1): on the first backend the compaction itself
# (permuting the ~11 state arrays through a [524k] argsort) cost more than
# the masked dead-lane work it saves. Not measured on the H100. Kept behind
# env knobs for narrower-width experiments; test coverage in
# tests/test_renderers.py::test_compaction_ladder_matches_flat.
import os as _os_l

LADDER_HEAD = int(_os_l.environ.get("PYRITE_TPU_LADDER_HEAD", "2"))
LADDER_DIV = int(_os_l.environ.get("PYRITE_TPU_LADDER_DIV", "1"))
LADDER_MIN_LANES = int(_os_l.environ.get("PYRITE_TPU_LADDER_MIN", "65536"))


def merged_traversal_enabled() -> bool:
    """Deferred-NEE merged traversal for cluster scenes
    (PYRITE_TPU_MERGE_TRAV=1): each bounce's NEE shadow batch and the next
    bounce's extension rays share ONE _cluster_traverse launch, so a bounce
    pays one walk's worth of per-iteration launches instead of two serial
    walks'. Off by default; not measured on the H100."""
    return _os_l.environ.get("PYRITE_TPU_MERGE_TRAV", "0") == "1"


def deferred_bounce(scene: Scene, cfg: TraceConfig, wavelengths, state, bounce_key, hit, ext_active):
    """One deferred bounce for cluster scenes: shade against the carried
    ``hit``, then run the bounce's NEE shadow batch and the NEXT bounce's
    extension rays through one merged traversal (intersect_merged).

    ``ext_active``: scalar or [N] mask — False suppresses the extension half
    (the caller's last bounce, whose scattered rays are never consumed).
    Returns (new_state incl. the NEE delta, info, next_hit). Estimator
    parity: bit-identical PRNG draws to bounce_core's in-line path
    (trace_direct_pre) and the same t semantics for both halves; only
    float-associativity-level sweep-order effects differ."""
    s_count = wavelengths.shape[1]
    new_state, info, nee = bounce_core(
        scene, cfg, wavelengths, state, bounce_key, hit=hit, defer_nee=True
    )
    ext = ext_active & new_state["alive"]
    next_hit, delta = merged_shadow_extension(
        scene, cfg, nee, new_state["origin"], new_state["direction"], ext,
        s_count,
    )
    if delta is not None:
        new_state = dict(new_state, brightness=new_state["brightness"] + delta)
    return new_state, info, next_hit


def merged_queries(scene: Scene, cfg: TraceConfig, shadow_queries, origin, direction, ext_active):
    """ONE merged traversal for any number of shadow query groups plus one
    extension batch. Each query is a dict with origin/direction/max_dist/
    block_below/contributes (the _direct_sample_pre shape); masked-off
    samples (contributes False) and inactive extension lanes are seeded
    inert (t=0: the root slab rejects everything, so they never cost a
    park/sweep slot). Returns (next_hit for the extension batch,
    [t per shadow group])."""
    n = origin.shape[0]
    if not shadow_queries:
        return intersect_scene(scene, origin, direction, cfg), []
    widths = [q["origin"].shape[0] for q in shadow_queries]
    all_o = jnp.concatenate([q["origin"] for q in shadow_queries] + [origin], axis=0)
    all_d = jnp.concatenate(
        [q["direction"] for q in shadow_queries] + [direction], axis=0
    )
    t_seed = jnp.concatenate(
        [jnp.where(q["contributes"], q["max_dist"], 0.0) for q in shadow_queries]
        + [jnp.where(ext_active, jnp.inf, 0.0)]
    )
    exit_b = jnp.concatenate(
        [q["block_below"] for q in shadow_queries] + [jnp.full(n, -jnp.inf)]
    )
    is_shadow = jnp.concatenate(
        [jnp.ones(sum(widths), bool), jnp.zeros(n, bool)]
    )
    best = intersect_merged(
        scene, all_o, all_d, cfg, t_seed, exit_b, is_shadow
    )
    ts, at = [], 0
    for w in widths:
        ts.append(best["t"][at : at + w])
        at += w
    next_hit = {k: v[at:] for k, v in best.items()}
    return next_hit, ts


def merged_shadow_extension(scene: Scene, cfg: TraceConfig, nee, origin, direction, ext_active, s_count):
    """ONE merged traversal for a deferred bounce: the bounce's NEE shadow
    batch (``nee`` = trace_direct_pre's (query, pending), or None) plus the
    caller's next extension rays. Returns (next_hit, nee_delta [N, S] or
    None). The regen scheduler calls this directly so it can mix
    regenerated camera rays into the extension half first."""
    n = origin.shape[0]
    if nee is None:
        return intersect_scene(scene, origin, direction, cfg), None
    query, pending = nee
    next_hit, (t_sh,) = merged_queries(
        scene, cfg, [query], origin, direction, ext_active
    )
    delta = trace_direct_post(pending, t_sh, n, s_count)
    return next_hit, delta


def trace_paths(scene: Scene, cfg: TraceConfig, key, origin, direction, wavelengths):
    """Trace a wavefront to completion and return per-sample radiance.

    ``wavelengths``: [N, S] with the hero at column 0.
    Returns (brightness [N, S], aux_alive [N])."""
    n = origin.shape[0]
    s_count = wavelengths.shape[1]

    state = {
        "origin": origin,
        "direction": direction,
        "brightness": jnp.zeros((n, s_count)),
        "reflectance": jnp.ones((n, s_count)),
        "alive": jnp.ones(n, bool),
        "aux_alive": jnp.ones(n, bool),
        "sample_light": jnp.ones(n, bool),
        "light_events": jnp.zeros(n, jnp.int32),
    }

    # Bounce loop with whole-wavefront early exit: once every lane is dead
    # the remaining bounces (up to 256 in the diamonds scene) are skipped
    # entirely instead of executing masked no-op work. The reference's
    # per-thread loop gets this for free (tracer.rs:208); a fixed lax.scan
    # would not.
    def tail(state, wl, start):
        def cond(carry):
            i, st = carry
            return (i < cfg.bounces) & jnp.any(st["alive"])

        def body(carry):
            i, st = carry
            new_st, _ = bounce_core(
                scene, cfg, wl, st, jax.random.fold_in(key, i)
            )
            return i + 1, new_st

        _, st = jax.lax.while_loop(cond, body, (jnp.int32(start), state))
        return st

    head, div = LADDER_HEAD, LADDER_DIV
    use_ladder = (
        div > 1
        and n % div == 0
        and n >= LADDER_MIN_LANES
        and cfg.bounces >= head + 2
    )
    if not use_ladder:
        if scene.use_clusters and merged_traversal_enabled():
            hit0 = intersect_scene(
                scene, state["origin"], state["direction"], cfg
            )

            def d_cond(carry):
                i, st, hit = carry
                return (i < cfg.bounces) & jnp.any(st["alive"])

            def d_body(carry):
                i, st, hit = carry
                new_st, _, next_hit = deferred_bounce(
                    scene, cfg, wavelengths, st, jax.random.fold_in(key, i),
                    hit, i + 1 < cfg.bounces,
                )
                return i + 1, new_st, next_hit

            _, state, _ = jax.lax.while_loop(
                d_cond, d_body, (jnp.int32(0), state, hit0)
            )
            return state["brightness"], state["aux_alive"]
        state = tail(state, wavelengths, 0)
        return state["brightness"], state["aux_alive"]

    for i in range(head):
        state, _ = bounce_core(
            scene, cfg, wavelengths, state, jax.random.fold_in(key, i)
        )

    # stable stream compaction: live lanes first, original relative order
    alive = state["alive"]
    perm = jnp.argsort(jnp.where(alive, 0, 1).astype(jnp.int32))
    state = {k: v[perm] for k, v in state.items()}
    wl_perm = wavelengths[perm]
    n_alive = jnp.sum(alive)

    def chunked(args):
        st, wl = args
        m = n // div
        outs = []
        for c in range(div):
            sl = slice(c * m, (c + 1) * m)
            sub = tail({k: v[sl] for k, v in st.items()}, wl[sl], head)
            outs.append(sub)
        return {k: jnp.concatenate([o[k] for o in outs]) for k in outs[0]}

    def flat(args):
        st, wl = args
        return tail(st, wl, head)

    state = jax.lax.cond(
        n_alive <= (n * 5) // 8, chunked, flat, (state, wl_perm)
    )
    # scatter results back to original lane order
    inv = jnp.zeros(n, jnp.int32).at[perm].set(jnp.arange(n, dtype=jnp.int32))
    return state["brightness"][inv], state["aux_alive"][inv]


def bounce_core(
    scene: Scene, cfg: TraceConfig, wavelengths, state, bounce_key,
    hit=None, defer_nee=False,
):
    """One camera-path bounce: intersection, contribution, NEE, scatter.

    Returns (new_state, info); info carries the surface interaction data a
    bidirectional connection step needs (position, normal, incident, bounce
    classification, stored-direction brdf).

    ``hit``: a precomputed intersect_scene result for state's current rays
    (the deferred cluster scheduler carries it from the previous bounce's
    merged traversal). ``defer_nee=True`` skips the in-line shadow query and
    returns (new_state, info, nee) where ``nee`` is trace_direct_pre's
    (query, pending) — or None — and new_state's brightness EXCLUDES the
    NEE delta; the caller traverses the query (batched with the next
    extension rays) and adds trace_direct_post's delta itself."""
    n = state["origin"].shape[0]
    s_count = wavelengths.shape[1]
    a = scene.arrays

    if True:  # keep the original body's indentation
        alive = state["alive"]
        o = state["origin"]
        d = state["direction"]

        if hit is None:
            hit = intersect_scene(scene, o, d, cfg)
        found = hit["kind"] != KIND_NONE

        position, normal_geo, quat, uv, mat_id = surface_data(scene, hit, o, d, cfg)

        # ---- miss: directional lamps then sky (tracer.rs:322-342) ----------
        miss = alive & ~found
        sky_inputs = ProgramInputs(
            wavelength=wavelengths, normal=-d, incident=d, uv=jnp.zeros((n, 2))
        )
        miss_color = jnp.broadcast_to(
            scene.sky_program(sky_inputs), (n, s_count)
        )
        if scene.directional_lamps:
            # check directional lamps: first whose direction.dot(ray) >= width
            taken = jnp.zeros(n, bool)
            dir_color = jnp.zeros((n, s_count))
            for lamp_dir, width, color_prog in scene.directional_lamps:
                lamp_dir = jnp.asarray(lamp_dir)
                match = (geom.dot(jnp.broadcast_to(lamp_dir, d.shape), d) >= width) & ~taken
                val = scene.color_programs[color_prog](sky_inputs)
                dir_color = dir_color + jnp.where(
                    match[:, None], jnp.broadcast_to(val, (n, s_count)), 0.0
                )
                taken |= match
            use_dir = state["sample_light"] & taken
            miss_color = jnp.where(use_dir[:, None], dir_color, miss_color)

        aux_cols = jnp.concatenate(
            [jnp.ones((n, 1), bool), jnp.broadcast_to(state["aux_alive"][:, None], (n, s_count - 1))],
            axis=1,
        )
        brightness = state["brightness"] + jnp.where(
            miss[:, None] & aux_cols, miss_color * state["reflectance"], 0.0
        )

        # ---- hit: material interaction -------------------------------------
        hit_active = alive & found
        k_nm, k_comp, k_scatter, k_nee = jax.random.split(bounce_key, 4)

        nm_inputs = ProgramInputs(
            wavelength=wavelengths, normal=normal_geo, incident=d, uv=uv
        )
        normal = apply_normal_maps(scene, mat_id, normal_geo, quat, nm_inputs)

        # uniform component choice (materials/mod.rs:48-54)
        count = jnp.maximum(a["mat_comp_count"][mat_id], 1)
        pick = jnp.minimum(
            (jax.random.uniform(k_comp, (n,)) * count).astype(jnp.int32), count - 1
        )
        comp = a["mat_comp_offset"][mat_id] + pick

        prob_inputs = ProgramInputs(
            wavelength=wavelengths, normal=normal, incident=d, uv=uv
        )
        comp_probability = eval_prob_bank(
            scene, a["comp_prob"][comp], prob_inputs, active=hit_active
        ) * a["comp_selection"][comp]
        normal_dispersed = a["comp_prob_uses_wl"][comp]

        sc = scatter(
            scene, comp, d, normal, wavelengths[:, 0], jax.random.uniform(k_scatter, (n, 3))
        )

        emitted = hit_active & sc["is_emissive"]
        reflected = hit_active & ~sc["is_emissive"]

        # --- emission (contribute() emission branch) -------------------------
        emit_now = emitted & state["sample_light"]
        aux_emit = jnp.concatenate(
            [
                jnp.ones((n, 1), bool),
                jnp.broadcast_to(
                    (state["aux_alive"] & ~normal_dispersed)[:, None], (n, s_count - 1)
                ),
            ],
            axis=1,
        )
        surface_color = eval_color_bank(
            scene, a["comp_color"][comp], prob_inputs, active=hit_active
        )
        brightness = brightness + jnp.where(
            emit_now[:, None] & aux_emit,
            surface_color * comp_probability[:, None] * state["reflectance"],
            0.0,
        )

        # --- reflection ------------------------------------------------------
        bounce_dispersed = sc["dispersed"] | normal_dispersed
        aux_alive = state["aux_alive"] & jnp.where(reflected, ~bounce_dispersed, True)
        aux_ref_cols = jnp.concatenate(
            [jnp.ones((n, 1), bool), jnp.broadcast_to(aux_alive[:, None], (n, s_count - 1))],
            axis=1,
        )

        refl_color = surface_color
        path_prob = sc["probability"] * comp_probability
        reflectance = jnp.where(
            reflected[:, None] & aux_ref_cols,
            state["reflectance"] * refl_color * path_prob[:, None],
            state["reflectance"],
        )

        # --- next-event estimation (only first 2 diffuse events) -------------
        nee_now = reflected & sc["is_diffuse"] & (state["light_events"] < 2)
        nee = None
        if cfg.light_samples > 0:
            if defer_nee:
                nee = trace_direct_pre(
                    scene, cfg, k_nee, nee_now, position, normal, d,
                    wavelengths, reflectance, aux_alive,
                )
            else:
                delta = trace_direct(
                    scene,
                    cfg,
                    k_nee,
                    nee_now,
                    position,
                    normal,
                    d,
                    wavelengths,
                    reflectance,
                    aux_alive,
                )
                brightness = brightness + delta
        light_events = state["light_events"] + jnp.where(
            reflected & sc["is_diffuse"] & (state["light_events"] < 2), 1, 0
        )
        # sample_light for the *next* bounce (tracer.rs:257-279)
        sample_light = jnp.where(
            reflected,
            jnp.where(
                state["light_events"] < 2,
                sc["is_specular"] | (cfg.light_samples == 0),
                True,
            ),
            state["sample_light"],
        )

        # --- apply BRDF and continue the path ---------------------------------
        brdf = brdf_value(normal, sc["out_dir"], sc["is_diffuse"])
        reflectance = jnp.where(
            reflected[:, None] & aux_ref_cols, reflectance * brdf[:, None], reflectance
        )

        new_origin = jnp.where(reflected[:, None], position, o)
        new_direction = jnp.where(reflected[:, None], sc["out_dir"], d)
        alive_next = alive & reflected

        new_state = {
            "origin": new_origin,
            "direction": new_direction,
            "brightness": brightness,
            "reflectance": reflectance,
            "alive": alive_next,
            "aux_alive": aux_alive,
            "sample_light": sample_light,
            "light_events": light_events,
        }
        info = {
            "position": position,
            "normal": normal,
            "incident": d,
            # per-bounce throughput factor color(lambda)*probability (before
            # the brdf), for chain-product consumers (photon mapping)
            "color_prob": refl_color * path_prob[:, None],
            # the factor split into its lambda-dependent part (the color
            # program id) and the scalar rest — lambda-only chains re-walk
            # EXACTLY at arbitrary wavelengths from these
            # (photon_mapping.rs:340-426 chain re-evaluation)
            "color_prog": a["comp_color"][comp],
            "path_prob": path_prob,
            "reflected": reflected,
            "is_diffuse": sc["is_diffuse"] & reflected,
            "dispersed": bounce_dispersed & reflected,
            # a vertex was recorded on this bounce (reflection, emission
            # while sampling lights, or a miss) -> counts toward path length
            "recorded": reflected | emit_now | miss,
            "brdf_stored": brdf,
            "miss": miss,
        }
        if defer_nee:
            return new_state, info, nee
        return new_state, info


# =============================================================================
# Lamp-path recording for bidirectional tracing (bidirectional.rs:125-202)
# =============================================================================


def sample_lamp_ray(scene: Scene, key, n):
    """Start light subpaths: pick a lamp uniformly and sample an outgoing ray
    (lamp.rs:84-113). Returns a dict of emitter-vertex data; 'valid' is False
    for directional lamps (they cannot start paths) or empty scenes."""
    a = scene.arrays
    k_pick, k_u, k_dir = jax.random.split(key, 3)
    lamp_idx = jax.random.randint(k_pick, (n,), 0, max(scene.num_lamps, 1))
    pick_prob = 1.0 / max(scene.num_lamps, 1)
    u = jax.random.uniform(k_u, (n, 4))

    ltype = a["lamp_type"][lamp_idx]
    lvec = a["lamp_vec"][lamp_idx]
    ref = jnp.maximum(a["lamp_ref"][lamp_idx], 0)

    position = jnp.zeros((n, 3))
    direction = jnp.zeros((n, 3))
    normal = jnp.zeros((n, 3))
    uv = jnp.zeros((n, 2))
    weight = jnp.ones(n)
    is_shape = jnp.zeros(n, bool)
    surf_mat = jnp.zeros(n, jnp.int32)
    valid = jnp.full(n, scene.num_lamps > 0)

    if LAMP_DIRECTIONAL in scene.lamp_types:
        valid &= ltype != LAMP_DIRECTIONAL

    if LAMP_POINT in scene.lamp_types:
        is_pt = ltype == LAMP_POINT
        pt_dir = geom.sample_sphere(u[:, 0], u[:, 1])
        position = jnp.where(is_pt[:, None], lvec, position)
        direction = jnp.where(is_pt[:, None], pt_dir, direction)
        normal = jnp.where(is_pt[:, None], pt_dir, normal)  # Surface::Color case
        weight = jnp.where(is_pt, 4.0 * jnp.pi, weight)

    if LAMP_SPHERE in scene.lamp_types:
        is_sph = ltype == LAMP_SPHERE
        s_center = a["sph_center"][ref]
        s_radius = a["sph_radius"][ref]
        unit = geom.sample_sphere(u[:, 0], u[:, 1])
        point = s_center + unit * s_radius[:, None]
        s_normal, _, s_uv = geom.sphere_surface_frame(
            point, s_center, a["sph_texscale"][ref]
        )
        s_dir = geom.sample_hemisphere(u[:, 2], u[:, 3], s_normal)
        s_area = s_radius * s_radius * 4.0 * jnp.pi
        position = jnp.where(is_sph[:, None], point, position)
        direction = jnp.where(is_sph[:, None], s_dir, direction)
        normal = jnp.where(is_sph[:, None], s_normal, normal)
        uv = jnp.where(is_sph[:, None], s_uv, uv)
        weight = jnp.where(is_sph, s_area, weight)
        is_shape |= is_sph
        surf_mat = jnp.where(is_sph, a["sph_mat"][ref], surf_mat)

    if LAMP_TRIANGLE in scene.lamp_types:
        is_tri = ltype == LAMP_TRIANGLE
        tu = u[:, 0]
        tv = u[:, 1]
        fold = tu + tv > 1.0
        tu = jnp.where(fold, 1.0 - tu, tu)
        tv = jnp.where(fold, 1.0 - tv, tv)
        t_v0 = a["tri_v0"][ref]
        t_e1 = a["tri_e1"][ref]
        t_e2 = a["tri_e2"][ref]
        point = t_v0 + t_e1 * tu[:, None] + t_e2 * tv[:, None]
        tw = 1.0 - tu - tv
        tn = a["tri_n"][ref]
        t_uv = a["tri_uv"][ref]
        t_normal = geom.normalize(
            tn[:, 0] * tw[:, None] + tn[:, 1] * tu[:, None] + tn[:, 2] * tv[:, None]
        )
        t_uv_i = (
            t_uv[:, 0] * tw[:, None]
            + t_uv[:, 1] * tu[:, None]
            + t_uv[:, 2] * tv[:, None]
        )
        t_dir = geom.sample_hemisphere(u[:, 2], u[:, 3], t_normal)
        t_area = _triangle_area(t_e1, t_e2)
        position = jnp.where(is_tri[:, None], point, position)
        direction = jnp.where(is_tri[:, None], t_dir, direction)
        normal = jnp.where(is_tri[:, None], t_normal, normal)
        uv = jnp.where(is_tri[:, None], t_uv_i, uv)
        weight = jnp.where(is_tri, t_area, weight)
        is_shape |= is_tri
        surf_mat = jnp.where(is_tri, a["tri_mat"][ref], surf_mat)

    return {
        "lamp_idx": lamp_idx,
        "pick_prob": pick_prob,
        "position": position,
        "direction": direction,
        "normal": normal,
        "uv": uv,
        "weight": weight,
        "is_shape": is_shape,
        "surf_mat": surf_mat,
        "color_prog": a["lamp_color"][lamp_idx],
        "valid": valid,
    }


def trace_lamp_path(scene: Scene, cfg: TraceConfig, key, wavelengths):
    """Build light subpaths with recorded vertices (bidirectional.rs:125-202).

    Returns a dict of [N, L+1, ...] arrays (vertex 0 = emitter) where L =
    cfg.bounces, containing everything the connection math needs:
      position, normal, uv, color_prog (program id), probability,
      is_diffuse, dispersed, valid, brdf (2|n.incident| factor for diffuse),
    plus 'length' [N] (number of valid vertices, trailing emission dropped).
    """
    n = wavelengths.shape[0]
    a = scene.arrays
    k_start, k_emis, k_trace = jax.random.split(key, 3)

    start = sample_lamp_ray(scene, k_start, n)

    # emissive material sampling at the emitter (bidirectional.rs:135-161)
    e_comp, e_sel = choose_emissive(
        scene, start["surf_mat"], jax.random.uniform(k_emis, (n,))
    )
    prob_inputs = ProgramInputs(
        wavelength=wavelengths,
        normal=start["normal"],
        incident=-start["direction"],
        uv=start["uv"],
    )
    mat_prob = eval_prob_bank(
        scene, a["comp_prob"][e_comp], prob_inputs, active=start["is_shape"]
    ) * e_sel
    mat_prob = jnp.where(start["is_shape"], mat_prob, 1.0)
    emitter_dispersed = jnp.where(
        start["is_shape"], a["comp_prob_uses_wl"][e_comp], False
    )
    emitter_color = jnp.where(
        start["is_shape"], a["comp_color"][e_comp], start["color_prog"]
    )
    # Bounce.probability for the emitter = weight / (pick_prob * material_prob)
    emitter_prob = start["weight"] / (
        start["pick_prob"] * jnp.maximum(mat_prob, 1e-20)
    )

    origin = start["position"] + start["normal"] * DIST_EPSILON

    # --- trace, recording vertices ------------------------------------------
    state = {
        "origin": origin,
        "direction": start["direction"],
        "alive": start["valid"],
    }

    def lamp_bounce_step(state, bounce_key):
        alive = state["alive"]
        o = state["origin"]
        d = state["direction"]

        hit = intersect_scene(scene, o, d, cfg)
        found = hit["kind"] != KIND_NONE
        position, normal_geo, quat, uv, mat_id = surface_data(scene, hit, o, d, cfg)

        k_nm, k_comp, k_scatter = jax.random.split(bounce_key, 3)
        nm_inputs = ProgramInputs(
            wavelength=wavelengths, normal=normal_geo, incident=d, uv=uv
        )
        normal = apply_normal_maps(scene, mat_id, normal_geo, quat, nm_inputs)

        count = jnp.maximum(a["mat_comp_count"][mat_id], 1)
        pick = jnp.minimum(
            (jax.random.uniform(k_comp, (n,)) * count).astype(jnp.int32), count - 1
        )
        comp = a["mat_comp_offset"][mat_id] + pick

        p_inputs = ProgramInputs(
            wavelength=wavelengths, normal=normal, incident=d, uv=uv
        )
        comp_probability = eval_prob_bank(
            scene, a["comp_prob"][comp], p_inputs, active=alive & found
        ) * a["comp_selection"][comp]
        normal_dispersed = a["comp_prob_uses_wl"][comp]

        sc = scatter(
            scene, comp, d, normal, wavelengths[:, 0],
            jax.random.uniform(k_scatter, (n, 3)),
        )

        reflected = alive & found & ~sc["is_emissive"]
        # valid recorded vertex: a real non-emission surface interaction
        # (emission hits terminate the light path and are dropped,
        # bidirectional.rs:194-201; misses record nothing)
        vertex = {
            "position": position,
            "normal": normal,
            "uv": uv,
            "color_prog": a["comp_color"][comp],
            "probability": sc["probability"] * comp_probability,
            "is_diffuse": sc["is_diffuse"],
            "dispersed": sc["dispersed"] | normal_dispersed,
            "valid": reflected,
            # after the reference's incident-reversal, the brdf factor of a
            # recorded diffuse vertex is 2|n.incident| (lambertian of the
            # direction it was reached from)
            "brdf": jnp.where(
                sc["is_diffuse"], 2.0 * jnp.abs(geom.dot(normal, d)), 1.0
            ),
            # brdf with the scattered out-direction: used only when the path
            # ends at the bounce limit and the trailing vertex keeps its
            # original out direction (never reassigned by pairs())
            "brdf_scatter": jnp.where(
                sc["is_diffuse"],
                2.0 * jnp.abs(geom.dot(normal, sc["out_dir"])),
                1.0,
            ),
            "incident_out": d,  # direction that arrived at this vertex
        }

        new_state = {
            "origin": jnp.where(reflected[:, None], position, o),
            "direction": jnp.where(reflected[:, None], sc["out_dir"], d),
            "alive": reflected,
        }
        return new_state, vertex

    keys = jax.random.split(k_trace, cfg.bounces)

    # while_loop with whole-batch early exit instead of a fixed lax.scan:
    # deep light budgets (snowflake/dragon run light_bounces = 256) would
    # otherwise execute the full masked depth long after every path died.
    # Vertices are recorded into preallocated [N, L, ...] buffers.
    probe = jax.eval_shape(lambda: lamp_bounce_step(state, keys[0])[1])
    bufs = jax.tree_util.tree_map(
        lambda s: jnp.zeros((n, cfg.bounces) + s.shape[1:], s.dtype), probe
    )

    def lamp_cond(carry):
        i, st, bufs = carry
        return (i < cfg.bounces) & jnp.any(st["alive"])

    def lamp_body(carry):
        i, st, bufs = carry
        new_state, vertex = lamp_bounce_step(st, keys[i])
        bufs = jax.tree_util.tree_map(
            lambda b, v: b.at[:, i].set(v), bufs, vertex
        )
        return i + 1, new_state, bufs

    _, _, recorded = jax.lax.while_loop(
        lamp_cond, lamp_body, (jnp.int32(0), state, bufs)
    )

    # prepend the emitter vertex
    def cat(first, rest):
        return jnp.concatenate([first[:, None], rest], axis=1)

    path = {
        "position": cat(origin, recorded["position"]),
        "normal": cat(start["normal"], recorded["normal"]),
        "uv": cat(start["uv"], recorded["uv"]),
        "color_prog": cat(emitter_color, recorded["color_prog"]),
        "probability": cat(emitter_prob, recorded["probability"]),
        "is_diffuse": cat(jnp.zeros(n, bool), recorded["is_diffuse"]),
        "dispersed": cat(emitter_dispersed, recorded["dispersed"]),
        "valid": cat(start["valid"], recorded["valid"]),
        "brdf": cat(jnp.ones(n), recorded["brdf"]),
        "incident_out": cat(start["direction"], recorded["incident_out"]),
    }
    path["brdf_limit"] = recorded["brdf_scatter"][:, -1]
    path["length"] = jnp.sum(path["valid"].astype(jnp.int32), axis=1)
    return path


# =============================================================================
# Clustered-BVH traversal (large scenes)
# =============================================================================

# Wide-tree pops between sweeps, leaves swept per parked lane per outer
# iteration, and the compaction width (sweep at most n // COMPACT_DIV parked
# lanes per outer iteration; lanes parked beyond the width wait for the next
# iteration). Not yet swept on the H100.
import os as _os

# ---- launch width alignment --------------------------------------------------
# Chunked launches (deferred connections, splat chunks, pool flushes) round
# their flattened lane count to a LAUNCH_ALIGN multiple through these two
# helpers. The value was set for the first backend's 1024-lane tiling; XLA
# on the GPU needs no alignment, and the H100 value is not measured yet.
LAUNCH_ALIGN = 1024


def aligned_chunk_rows(cap_rows: int, unit: int = 1) -> int:
    """Largest row count <= cap_rows whose flattened lane count
    (rows * unit) is a LAUNCH_ALIGN multiple — used to round a per-chunk
    budget DOWN to a safe dispatch width. Never returns less than the
    minimum aligned count (so a tiny cap still yields a legal launch)."""
    from math import gcd

    k = LAUNCH_ALIGN // gcd(max(unit, 1), LAUNCH_ALIGN)
    return max(k, (cap_rows // k) * k)


def aligned_width(width: int, unit: int = 1) -> int:
    """Smallest width >= max(width, 1) whose flattened lane count
    (width * unit) is a LAUNCH_ALIGN multiple — used to round a launch
    width UP (callers pad the operands to match)."""
    from math import gcd

    k = LAUNCH_ALIGN // gcd(max(unit, 1), LAUNCH_ALIGN)
    return ((max(width, 1) + k - 1) // k) * k


# Lanes per launch on the cluster (wide-BVH) path. The walk's per-outer-
# iteration cost at 32k lanes is mostly fixed launch cost (~60 small ops per
# round), so wider launches amortize it; overridable for sweeps.
CLUSTER_LANE_CAP = int(_os.environ.get("PYRITE_TPU_CLUSTER_LANES", "32768"))
CLUSTER_WALK_STEPS = int(_os.environ.get("PYRITE_TPU_WALK_STEPS", "2"))
SWEEP_LEAVES = int(_os.environ.get("PYRITE_TPU_SWEEP_LEAVES", "2"))
COMPACT_DIV = int(_os.environ.get("PYRITE_TPU_COMPACT_DIV", "8"))
# pending-leaf registers per lane (1 = classic walk; 2 = a lane keeps
# walking while one cluster's leaves await their sweep)
CLUSTER_PENDING_REGS = int(_os.environ.get("PYRITE_TPU_PENDING_REGS", "2"))
# fetch walk rows via a one-hot [N, rows] @ [rows, 128] matmul instead of a
# dynamic row-gather from the [273, 128] node table (the choice is not yet
# measured on the H100)
CLUSTER_ONEHOT_ROWS = int(_os.environ.get("PYRITE_TPU_ONEHOT_ROWS", "1"))
# one-hot fetch width ceiling: the [N, rows] one-hot round-trips HBM, so it
# only pays at wavefront widths, and a
# megawide flattened batch (BDPT connection/splat queries reach
# n*slots = 1M-8M lanes) would allocate a [N, 273] f32 sheet per pop
# (1-9 GB). Above the cap the walk falls back to the dynamic row-gather.
CLUSTER_ONEHOT_MAX = int(_os.environ.get("PYRITE_TPU_ONEHOT_MAX", "65536"))
# carry the query state through the XLA walk as ONE packed [n, S] f32 sheet
# so each compaction round moves 1 gather + 1 scatter instead of ~2 ops per
# state leaf (op count, not bytes, bounded the compaction block on the
# first backend; not measured on the H100)
CLUSTER_PACK_STATE = int(_os.environ.get("PYRITE_TPU_PACK_STATE", "1"))

# Ray-coherence sort of the cluster wavefront before traversal (1 =
# direction octant, 2 = octant + 4^3 coarse origin cell); un-permuted on
# exit, so results are lane-identical. Round-5 terrain experiment.
_WALK_SORT = int(_os.environ.get("PYRITE_TPU_WALK_SORT", "0"))
COMPACT_MIN = 4096  # below this many lanes, masked sweeps beat compaction
# sweep-width ceiling via the leaf-geometry gather's transient footprint:
# a sweep gathers [width, SWEEP_LEAVES * leaf, 12] f32, and callers can
# flatten VERY wide batches through one traversal (a dragon-class BDPT
# splat/connection query is 32k pixels x 256 lamp slots = 8.4M lanes;
# width = n/8 then allocates a 38 GB gather and the compile OOMs). The
# cap bounds the gather to ~1.5 GB; excess parked lanes wait, exactly
# like lanes beyond the width did already.
SWEEP_GATHER_BUDGET = int(
    _os.environ.get("PYRITE_TPU_SWEEP_GATHER_BUDGET", str(3 * 2**29))
)


def _lowbit_index(m):
    """Index of the lowest set bit (0 for m == 0). Exact via float log2:
    masks are 16-bit, far inside f32's exact-integer range."""
    lb = (m & -m).astype(jnp.float32)
    return jnp.round(jnp.log2(jnp.maximum(lb, 1.0))).astype(jnp.int32)


def _pop_bit(m, from_high):
    """Pop the lowest (or highest, per lane) set bit: returns (k, m')."""
    kl = _lowbit_index(m)
    kh = jnp.floor(
        jnp.log2(jnp.maximum(m, 1).astype(jnp.float32) + 0.5)
    ).astype(jnp.int32)
    k = jnp.where(from_high, kh, kl)
    return k, m & ~(1 << k)


def _axis_sign(row, direction):
    """Whether the ray direction is negative along the row's child-sort axis
    (row column 96) — i.e. whether front-to-back order pops from the high end."""
    axis = row[:, 96].astype(jnp.int32)
    d = jnp.where(
        axis == 0,
        direction[:, 0],
        jnp.where(axis == 1, direction[:, 1], direction[:, 2]),
    )
    return d < 0.0


def _slab16(row, origin, inv_dir, t_best):
    """Slab test of 16 child AABBs per lane against the lane's ray.

    ``row`` is [N, 128] (or [1, 128] broadcast): columns are
    [minx(16) | miny | minz | maxx | maxy | maxz | axis | validity | pad].
    Returns an int32 bitmask of valid children hit with entry < t_best
    (math.rs:184-207 semantics, matching bvh.aabb_entry_distance). The
    explicit validity mask is required: the sorted slab test cannot reject
    an empty (inverted) sentinel box."""
    o = origin[:, :, None]
    i = inv_dir[:, :, None]
    lo = jnp.stack([row[:, 0:16], row[:, 16:32], row[:, 32:48]], axis=1)
    hi = jnp.stack([row[:, 48:64], row[:, 64:80], row[:, 80:96]], axis=1)
    t1 = (lo - o) * i
    t2 = (hi - o) * i
    tmin = jnp.max(jnp.minimum(t1, t2), axis=1)
    tmax = jnp.min(jnp.maximum(t1, t2), axis=1)
    hit = (tmax >= tmin) & (tmax >= 0.0) & (jnp.maximum(tmin, 0.0) < t_best[:, None])
    shifts = (1 << jnp.arange(16)).astype(jnp.int32)
    bits = jnp.sum(hit.astype(jnp.int32) * shifts[None, :], axis=1)
    return bits & row[:, 97].astype(jnp.int32)


def _cluster_traverse(
    scene: Scene, origin, direction, init_state, leaf_sweep, exit_below=None
):
    """Wide-BVH (16-ary) traversal with bitmask stacks and ray compaction.

    Per lane, the pending set at each of the 3 levels is a 16-bit mask (set
    by one slab test of all 16 children of a popped node), so traversal
    state is three ints — no stack. Each pop costs ONE [128]-float
    row-gather (a 16-wide node replaces ~4 binary skip-link steps); positional
    node/leaf numbering (bvh.build_wide_bvh) means no pointer gathers.

    Each outer iteration advances every ray up to CLUSTER_WALK_STEPS pops
    (lanes holding pending leaves park), compacts the parked lanes into a
    dense prefix (cumsum + scatter — sweep gathers and intersection FLOPs
    scale with the parked count, not the batch size), and runs one
    vectorized [parked, CLUSTER_LEAF] sweep; a parked lane fetches its whole
    leaf cluster with a single row-gather from clu_geo. For any-hit queries
    ``exit_below`` terminates a lane at its first definitive blocker.

    Everything is plain masked array math over the wavefront, with no
    vmapped per-ray while_loops. Pruning
    semantics match the reference's streaming traversal (spatial/
    bvh.rs:201-230): subtrees are skipped when missed or entered beyond the
    current best hit."""
    if _WALK_SORT:
        # Experiment (PYRITE_TPU_WALK_SORT): sort the wavefront by
        # direction octant (+ coarse origin cell at =2) so lanes walking
        # the same subtrees sit adjacent, then un-permute the result.
        # argsort at the 32k-lane walk width is micro-scale (the forbidden
        # 524k-lane measurement does not apply).
        oct_key = (
            (direction[:, 0] < 0).astype(jnp.int32) * 4
            + (direction[:, 1] < 0).astype(jnp.int32) * 2
            + (direction[:, 2] < 0).astype(jnp.int32)
        )
        if _WALK_SORT == 2:
            lo = jnp.min(origin, axis=0)
            span = jnp.maximum(jnp.max(origin, axis=0) - lo, 1e-6)
            cell = jnp.clip(
                ((origin - lo) / span * 4.0).astype(jnp.int32), 0, 3
            )
            oct_key = oct_key * 64 + cell[:, 0] * 16 + cell[:, 1] * 4 + cell[:, 2]
        order = jnp.argsort(oct_key)
        inv_order = jnp.argsort(order)
        out = _cluster_traverse_inner(
            scene, origin[order], direction[order],
            {k: v[order] for k, v in init_state.items()},
            leaf_sweep,
            exit_below=None if exit_below is None else (
                exit_below[order]
                if getattr(exit_below, "ndim", 0) else exit_below
            ),
        )
        return {k: v[inv_order] for k, v in out.items()}
    return _cluster_traverse_inner(
        scene, origin, direction, init_state, leaf_sweep, exit_below
    )


def _cluster_traverse_inner(
    scene: Scene, origin, direction, init_state, leaf_sweep, exit_below=None
):
    rows = scene.arrays["wide_rows"]  # [273, 128]
    max_slot = scene.cluster_slots - 1

    inv_dir = 1.0 / direction
    n = origin.shape[0]
    lane_ids = jnp.arange(n, dtype=jnp.int32)

    width_cap = max(
        COMPACT_MIN,
        SWEEP_GATHER_BUDGET // (SWEEP_LEAVES * scene.cluster_leaf * 48),
    )
    width = min(n // COMPACT_DIV, width_cap)
    compact = n >= COMPACT_MIN and width > 0

    if CLUSTER_ONEHOT_ROWS and n <= CLUSTER_ONEHOT_MAX:
        # Node-row fetch as a one-hot matmul instead of a dynamic
        # row-gather. Sentinel +-inf box planes are clamped to +-1e30 first
        # (0 * inf = NaN would poison every fetched row); an inverted 1e30
        # box still never passes the slab test, and the row validity bitmask
        # (col 97) masks empty child slots regardless.
        rows_fin = jnp.clip(rows, -1e30, 1e30)
        row_iota = jnp.arange(rows.shape[0], dtype=jnp.int32)

        def fetch_rows(idx):
            oh = (idx[:, None] == row_iota[None, :]).astype(rows.dtype)
            return oh @ rows_fin

    else:
        def fetch_rows(idx):
            return rows[idx]

    # state packing (see CLUSTER_PACK_STATE): kind/idx/leaf ids are exact in
    # f32 (all < 2^24), so the sheet round-trips every state leaf losslessly
    pack_lanes = CLUSTER_PACK_STATE
    skeys = sorted(init_state)
    sdtypes = [init_state[k].dtype for k in skeys]
    t_col = skeys.index("t")

    def pack_state(st):
        return jnp.stack([st[k].astype(jnp.float32) for k in skeys], axis=1)

    def unpack_state(sheet):
        return {
            k: sheet[:, i].astype(dt)
            for i, (k, dt) in enumerate(zip(skeys, sdtypes))
        }

    ray6 = jnp.concatenate([origin, direction], axis=1)

    root = rows[0:1]
    m0 = _slab16(root, origin, inv_dir, init_state["t"])
    ph0 = _axis_sign(jnp.broadcast_to(root, (n, 128)), direction)
    zeros = jnp.zeros(n, jnp.int32)
    false = jnp.zeros(n, bool)
    carry0 = (
        m0, zeros, zeros, zeros, zeros, ph0, false, false,
        zeros, zeros, false,
        pack_state(init_state) if pack_lanes else init_state,
    )

    def outer_cond(carry):
        m0, m1, m2, m2b = carry[0], carry[1], carry[2], carry[8]
        return jnp.any((m0 | m1 | m2 | m2b) != 0)

    def outer_body(carry):
        m0, m1, m2, cur1, cur2, ph0, ph1, ph2, m2b, cur2b, ph2b, state = carry
        regs2 = CLUSTER_PENDING_REGS >= 2
        t_cur = state[:, t_col] if pack_lanes else state["t"]

        def pop(_, walk):
            m0, m1, m2, cur1, cur2, ph0, ph1, ph2, m2b, cur2b, ph2b = walk
            # a lane stalls (parks) only when every pending-leaf register is
            # full; with the second register a lane can keep walking while
            # one cluster's leaves await their sweep, halving the worst
            # lane's walk-bound outer iterations
            parked = (m2 != 0) & (m2b != 0) if regs2 else (m2 != 0)
            act1 = ~parked & (m1 != 0)  # pop an L2 node from cur1's mask
            act0 = ~parked & (m1 == 0) & (m0 != 0)  # pop an L1 node
            k1, m1_pop = _pop_bit(m1, ph1)
            k0, m0_pop = _pop_bit(m0, ph0)
            row_idx = jnp.where(
                parked,
                17 + cur2,
                jnp.where(act1, 17 + cur1 * 16 + k1, jnp.where(act0, 1 + k0, 0)),
            )
            row = fetch_rows(row_idx)
            bits = _slab16(row, origin, inv_dir, t_cur)
            sign = _axis_sign(row, direction)
            if regs2:
                into_a = act1 & (m2 == 0)
                into_b = act1 & (m2 != 0)
                m2b = jnp.where(into_b, bits, m2b)
                ph2b = jnp.where(into_b, sign, ph2b)
                cur2b = jnp.where(into_b, cur1 * 16 + k1, cur2b)
            else:
                into_a = act1
            # a parked lane re-prunes its pending register-a leaves with the
            # current best t
            m2 = jnp.where(parked, m2 & bits, jnp.where(into_a, bits, m2))
            ph2 = jnp.where(into_a, sign, ph2)
            cur2 = jnp.where(into_a, cur1 * 16 + k1, cur2)
            m1 = jnp.where(act1, m1_pop, jnp.where(act0, bits, m1))
            ph1 = jnp.where(act0, sign, ph1)
            cur1 = jnp.where(act0, k0, cur1)
            m0 = jnp.where(act0, m0_pop, m0)
            return m0, m1, m2, cur1, cur2, ph0, ph1, ph2, m2b, cur2b, ph2b

        m0, m1, m2, cur1, cur2, ph0, ph1, ph2, m2b, cur2b, ph2b = jax.lax.fori_loop(
            0, CLUSTER_WALK_STEPS, pop,
            (m0, m1, m2, cur1, cur2, ph0, ph1, ph2, m2b, cur2b, ph2b),
        )

        at_leaf = (m2 | m2b) != 0
        # pop up to SWEEP_LEAVES pending leaves per parked lane, draining
        # register a before register b (popping an empty mask is a no-op:
        # it yields bit 0 and stays empty)
        ks, rest_a, rest_b = [], m2, m2b
        for _ in range(SWEEP_LEAVES):
            use_a = rest_a != 0
            k_a, rest_a_next = _pop_bit(rest_a, ph2)
            k_b, rest_b_next = _pop_bit(rest_b, ph2b)
            leaf = jnp.where(use_a, cur2 * 16 + k_a, cur2b * 16 + k_b)
            ks.append((leaf, use_a | (rest_b != 0)))
            rest_a = jnp.where(use_a, rest_a_next, rest_a)
            rest_b = jnp.where(use_a, rest_b, rest_b_next)
        m2_pop, m2b_pop = rest_a, rest_b
        leaf_ids = jnp.stack(
            [jnp.minimum(leaf, max_slot) for leaf, _ in ks], axis=1
        )
        leaf_act = jnp.stack([has for _, has in ks], axis=1)

        if not compact:
            st_dict = unpack_state(state) if pack_lanes else state
            updated = leaf_sweep(leaf_ids, origin, direction, st_dict, leaf_act)
            if pack_lanes:
                state = jnp.where(at_leaf[:, None], pack_state(updated), state)
            else:
                state = jax.tree_util.tree_map(
                    lambda new, old: jnp.where(at_leaf, new, old), updated, state
                )
            swept = at_leaf
        else:
            # ray compaction: scatter the first `width` parked lane ids into
            # a dense prefix, sweep only those, scatter results back.
            # (A hashed slot-claim variant without the cumsum lost: fixed
            # lane->slot residues serialize persistently colliding lanes.)
            pos = jnp.cumsum(at_leaf) - 1
            swept = at_leaf & (pos < width)
            sel = (
                jnp.zeros(width, jnp.int32)
                .at[jnp.where(swept, pos, width)]
                .set(lane_ids, mode="drop")
            )
            n_swept = jnp.minimum(jnp.sum(at_leaf), width)
            valid = jnp.arange(width) < n_swept

            if pack_lanes:
                # one concat + one row-gather moves the ray, the pending
                # leaves, and the whole query state for the swept prefix
                q = leaf_ids.shape[1]
                sheet = jnp.concatenate(
                    [
                        ray6,
                        leaf_ids.astype(jnp.float32),
                        leaf_act.astype(jnp.float32),
                        state,
                    ],
                    axis=1,
                )
                sub = sheet[sel]
                updated = leaf_sweep(
                    sub[:, 6:6 + q].astype(jnp.int32),
                    sub[:, 0:3], sub[:, 3:6],
                    unpack_state(sub[:, 6 + 2 * q:]),
                    (sub[:, 6 + q:6 + 2 * q] > 0.5) & valid[:, None],
                )
                back = jnp.where(valid, sel, n)
                state = state.at[back].set(pack_state(updated), mode="drop")
            else:
                sub_state = jax.tree_util.tree_map(lambda x: x[sel], state)
                updated = leaf_sweep(
                    leaf_ids[sel], origin[sel], direction[sel], sub_state,
                    leaf_act[sel] & valid[:, None],
                )
                # unselected slots alias a real lane: drop on the way back
                back = jnp.where(valid, sel, n)
                state = jax.tree_util.tree_map(
                    lambda old, new: old.at[back].set(new, mode="drop"),
                    state,
                    updated,
                )

        m2 = jnp.where(swept, m2_pop, m2)
        m2b = jnp.where(swept, m2b_pop, m2b)
        # promote a drained register a from b so subsequent pops refill b
        promote = (m2 == 0) & (m2b != 0)
        m2 = jnp.where(promote, m2b, m2)
        cur2 = jnp.where(promote, cur2b, cur2)
        ph2 = jnp.where(promote, ph2b, ph2)
        m2b = jnp.where(promote, 0, m2b)
        if exit_below is not None:
            # any-hit query: a lane that found a definitive blocker exits
            done = (state[:, t_col] if pack_lanes else state["t"]) < exit_below
            m0 = jnp.where(done, 0, m0)
            m1 = jnp.where(done, 0, m1)
            m2 = jnp.where(done, 0, m2)
            m2b = jnp.where(done, 0, m2b)
        return m0, m1, m2, cur1, cur2, ph0, ph1, ph2, m2b, cur2b, ph2b, state

    carry = jax.lax.while_loop(outer_cond, outer_body, carry0)
    return unpack_state(carry[-1]) if pack_lanes else carry[-1]


def _leaf_geometry(scene: Scene, leaf_ids, active):
    """Gather SWEEP_LEAVES whole leaf clusters per lane (one row-gather per
    lane per leaf) and flatten them into a [P, Q*LEAF, 12] prim sheet with a
    matching activity mask."""
    geo = scene.arrays["clu_geo"]  # [slots, CLUSTER_LEAF, 12] (scene.py)
    p, q = leaf_ids.shape
    leaf = geo.shape[1]
    g = geo[leaf_ids].reshape(p, q * leaf, 12)
    act = jnp.repeat(active, leaf, axis=1)
    return g, act


def _cluster_leaf_closest(scene: Scene):
    """Vectorized leaf sweep for closest-hit queries: [N, Q*LEAF] tests, one
    geometry row-gather per lane per leaf, gather-free row-min selection.
    On the kernel path the Triton sweep (kernels.sweep) takes its place."""
    kernel_sweep = _kernel_leaf_sweep(scene, shadow=False)
    if kernel_sweep is not None:
        return kernel_sweep

    def leaf_sweep(leaf_ids, origin, direction, state, active):
        g, act = _leaf_geometry(scene, leaf_ids, active)
        o = origin[:, None, :]
        d = direction[:, None, :]
        tri_ok, tri_t, u, v = geom.ray_triangle(
            o, d, g[..., 0:3], g[..., 3:6], g[..., 6:9]
        )
        sph_ok, sph_t = geom.ray_sphere(o, d, g[..., 0:3], g[..., 9])
        kind = g[..., 10]
        is_tri = kind == PRIM_TRIANGLE
        ok = jnp.where(is_tri, tri_ok, sph_ok & (kind == PRIM_SPHERE))
        ok = ok & act  # padded slots have kind == -1
        t = jnp.where(ok, jnp.where(is_tri, tri_t, sph_t), jnp.inf)
        # gather-free row-min selection: pick the first column achieving the
        # minimum via a masked sum instead of take_along_axis
        tj = jnp.min(t, axis=1)
        hitmin = ok & (t == tj[:, None])
        first = hitmin & (jnp.cumsum(hitmin, axis=1) == 1)
        pick = lambda arr: jnp.sum(jnp.where(first, arr, 0.0), axis=1)
        better = tj < state["t"]
        won_tri = pick(is_tri.astype(jnp.float32)) > 0.5
        return {
            "t": jnp.where(better, tj, state["t"]),
            "kind": jnp.where(
                better,
                jnp.where(won_tri, KIND_TRIANGLE, KIND_SPHERE),
                state["kind"],
            ),
            "idx": jnp.where(
                better, pick(g[..., 11]).astype(jnp.int32), state["idx"]
            ),
            "u": jnp.where(better, pick(u), state["u"]),
            "v": jnp.where(better, pick(v), state["v"]),
        }

    return leaf_sweep


def _kernel_leaf_sweep(scene: Scene, shadow: bool):
    """The Triton leaf sweep where the path rule picks kernels, else None."""
    from . import kernels

    if kernels.kernel_path() == "xla" or scene.cluster_leaf % kernels.SWEEP_TILE:
        return None

    def sweep(leaf_ids, origin, direction, state, active):
        return kernels.sweep(
            scene.arrays["clu_geo_ch"], scene.cluster_leaf, leaf_ids, active,
            origin, direction, state, shadow,
        )

    return sweep


def _cluster_leaf_shadow(scene: Scene):
    kernel_sweep = _kernel_leaf_sweep(scene, shadow=True)
    if kernel_sweep is not None:
        return kernel_sweep
    def leaf_sweep(leaf_ids, origin, direction, state, active):
        g, act = _leaf_geometry(scene, leaf_ids, active)
        o = origin[:, None, :]
        d = direction[:, None, :]
        tri_ok, tri_t, _, _ = geom.ray_triangle(
            o, d, g[..., 0:3], g[..., 3:6], g[..., 6:9]
        )
        sph_ok, sph_t = geom.ray_sphere(o, d, g[..., 0:3], g[..., 9])
        kind = g[..., 10]
        is_tri = kind == PRIM_TRIANGLE
        ok = jnp.where(is_tri, tri_ok, sph_ok & (kind == PRIM_SPHERE))
        ok = ok & act
        t = jnp.where(ok, jnp.where(is_tri, tri_t, sph_t), jnp.inf)
        return {"t": jnp.minimum(state["t"], jnp.min(t, axis=1))}

    return leaf_sweep

