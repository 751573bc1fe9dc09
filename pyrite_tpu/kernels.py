"""Pallas kernels, lowered through Triton for the GPU.

Two kernels live here: the distance-estimator sphere trace and the
wide-BVH leaf sweep (see its section below). In XLA
(tracer._intersect_de) the march is a while_loop over the whole wavefront:
every iteration launches the fused estimator kernels at full width, its
``jnp.any`` predicate goes back to the host, and the loop runs until the
slowest lane of the whole wavefront converges. The Triton kernel gives each
block of MARCH_BLOCK lanes its own program: the julia/mandelbulb orbit state
stays in registers, and a block leaves its loop as soon as its own lanes are
done.

Path rule (``kernel_path``): the kernels on the GPU, the XLA versions on the
CPU. There is no silent fallback: a kernel that fails to compile on the GPU
raises, and asking for the compiled kernel elsewhere raises. Interpret mode
runs only where a caller asks for it explicitly (``use_path("interpret")``,
the parity tests).
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

# Lanes per Triton program (a power of two; inputs are padded only up to a
# multiple of it) and warps per program: one lane per thread. 64/2 and
# 128/4 tied on the H100 and were the fastest of 64..512 lanes (PERF.md).
MARCH_BLOCK = 64
MARCH_WARPS = 2

PATHS = ("kernel", "xla", "interpret")
_forced_path = None


def kernel_path() -> str:
    """Which path the kernels take: "kernel" (compiled Triton) on the GPU,
    "xla" elsewhere, or whatever an enclosing ``use_path`` forces."""
    if _forced_path is not None:
        return _forced_path
    return "kernel" if jax.default_backend() == "gpu" else "xla"


def _interpret(kernel: str) -> bool:
    """Whether a kernel call interprets (True) or compiles (False). Raises
    on the XLA path, and for a compiled kernel off the GPU."""
    path = kernel_path()
    if path == "xla":
        raise ValueError(f"{kernel} called on the XLA path")
    if path == "kernel" and jax.default_backend() != "gpu":
        raise RuntimeError(
            f"the Triton {kernel} kernel compiles only for a GPU (backend is "
            f"{jax.default_backend()!r}); use the XLA path or interpret mode"
        )
    return path == "interpret"


class use_path:
    """Context manager forcing the kernel path for everything traced within
    (tests and the smoke check compare the kernels with the XLA versions)."""

    def __init__(self, path: str):
        if path not in PATHS:
            raise ValueError(f"unknown kernel path {path!r}; expected one of {PATHS}")
        self.path = path

    def __enter__(self):
        global _forced_path
        self._prev = _forced_path
        _forced_path = self.path
        return self

    def __exit__(self, *exc):
        global _forced_path
        _forced_path = self._prev
        return False


def _de_step_mandelbulb(est):
    iterations = est["iterations"]
    threshold = est["threshold"]
    power = est["power"]
    constant = est["constant"]
    dc = 1.0 if constant is None else 0.0

    def distance(px, py, pz):
        zx, zy, zz = px, py, pz
        r = jnp.zeros_like(px)
        dr = jnp.ones_like(px)
        done = jnp.zeros_like(px, jnp.int32)
        cx, cy, cz = (
            (px, py, pz) if constant is None else
            (constant[0], constant[1], constant[2])
        )
        for _ in range(iterations):
            r_new = jnp.sqrt(jnp.maximum(zx * zx + zy * zy + zz * zz, 1e-30))
            done_now = done | (r_new > threshold).astype(jnp.int32)
            theta = jnp.arccos(jnp.clip(zz / r_new, -1.0, 1.0)) * power
            phi = jnp.arctan2(zy, zx) * power
            dr_new = r_new ** (power - 1.0) * power * dr + dc
            zr = r_new ** power
            st = jnp.sin(theta)
            nx = st * jnp.cos(phi) * zr + cx
            ny = jnp.sin(phi) * st * zr + cy
            nz = jnp.cos(theta) * zr + cz
            keep = done_now == 0
            zx = jnp.where(keep, nx, zx)
            zy = jnp.where(keep, ny, zy)
            zz = jnp.where(keep, nz, zz)
            r = jnp.where(done != 0, r, r_new)
            dr = jnp.where(keep, dr_new, dr)
            done = done_now
        return 0.5 * jnp.log(jnp.maximum(r, 1e-30)) * r / dr

    return distance


def _de_step_julia(est):
    iterations = est["iterations"]
    threshold = est["threshold"]
    constant = est["constant"]
    variant = est["variant"]
    slice_plane = est["slice_plane"]

    def qmul(a, b):
        s1, x1, y1, z1 = a
        s2, x2, y2, z2 = b
        return (
            s1 * s2 - x1 * x2 - y1 * y2 - z1 * z2,
            s1 * x2 + x1 * s2 + y1 * z2 - z1 * y2,
            s1 * y2 - x1 * z2 + y1 * s2 + z1 * x2,
            s1 * z2 + x1 * y2 - y1 * x2 + z1 * s2,
        )

    def qsq(q):
        # z*z for a quaternion commuting with itself: (s^2-|v|^2, 2s*v) —
        # 9 flops vs qmul's 28
        s, x, y, z = q
        v2 = x * x + y * y + z * z
        s2 = s + s
        return (s * s - v2, s2 * x, s2 * y, s2 * z)

    def bmul(a, b):
        x1, y1, z1, w1 = a
        x2, y2, z2, w2 = b
        return (
            x1 * x2 - y1 * y2 - z1 * z2 + w1 * w2,
            x1 * y2 + y1 * x2 - z1 * w2 - w1 * z2,
            x1 * z2 - y1 * w2 + z1 * x2 - w1 * y2,
            x1 * w2 + y1 * z2 + z1 * y2 + w1 * x2,
        )

    def bsq(q):
        x, y, z, w = q
        return (
            x * x - y * y - z * z + w * w,
            2.0 * (x * y - z * w),
            2.0 * (x * z - y * w),
            2.0 * (x * w + y * z),
        )

    def scale(q, f):
        return tuple(c * f for c in q)

    # (z_pow, dz_pow) with the square shared and the derivative chain
    # re-associated (quaternion/bicomplex multiplication is associative:
    # (dz*z)*z = dz*z^2) — distance_estimators.rs:44-94 semantics at ~60%
    # of the flops
    if variant == "regular":
        pow_step = lambda z, dz: (qsq(z), scale(qmul(dz, z), 2.0))
    elif variant == "cubic":
        def pow_step(z, dz):
            q2 = qsq(z)
            return qmul(q2, z), scale(qmul(dz, q2), 3.0)
    else:
        def pow_step(z, dz):
            q2 = bsq(z)
            return q2, scale(bmul(dz, q2), 2.0)

    def distance(px, py, pz):
        z = (px, py, pz, jnp.full_like(px, slice_plane))
        dz = (
            jnp.ones_like(px), jnp.zeros_like(px),
            jnp.zeros_like(px), jnp.zeros_like(px),
        )
        # escape radius carried SQUARED: the threshold test r > T is
        # r^2 > T^2 for positives, so the per-iteration sqrt collapses to
        # ONE final sqrt
        r2 = jnp.zeros_like(px)
        done = jnp.zeros_like(px, jnp.int32)
        thr2 = float(threshold) * float(threshold)
        for _ in range(iterations):
            r2_new = sum(c * c for c in z)
            done_now = done | (r2_new > thr2).astype(jnp.int32)
            zp, dz_new = pow_step(z, dz)
            z_new = tuple(c + k for c, k in zip(zp, constant))
            keep = done_now == 0
            z = tuple(jnp.where(keep, n, o) for n, o in zip(z_new, z))
            dz = tuple(jnp.where(keep, n, o) for n, o in zip(dz_new, dz))
            r2 = jnp.where(done != 0, r2, r2_new)
            done = done_now
        r = jnp.sqrt(jnp.maximum(r2, 1e-30))
        dz_mag = jnp.sqrt(jnp.maximum(sum(c * c for c in dz), 1e-30))
        return 0.5 * jnp.log(jnp.maximum(r, 1e-30)) * r / dz_mag

    return distance


_DIST_EPS = 1e-4


def _any(mask):
    """Block-wide "any lane" as an integer max: the Triton route lowers no
    boolean reduce_or."""
    return jnp.max(mask.astype(jnp.int32)) > 0


def _make_march_kernel(est, max_steps):
    distance = (
        _de_step_mandelbulb(est)
        if est["kind"] == "mandelbulb"
        else _de_step_julia(est)
    )
    omega = float(est.get("omega", 1.0))

    def kernel(
        ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref,
        t0_ref, tmax_ref, hit_ref,
        o_total, o_dist,
    ):
        ox, oy, oz = ox_ref[:], oy_ref[:], oz_ref[:]
        dx, dy, dz = dx_ref[:], dy_ref[:], dz_ref[:]
        tmax = tmax_ref[:]
        hit = hit_ref[:]

        def eval_d(total):
            return distance(ox + dx * total, oy + dy * total, oz + dz * total)

        total0 = t0_ref[:]
        dist0 = jnp.full_like(total0, 1e30)

        def live(total, dist):
            return (total < tmax) & (dist >= _DIST_EPS) & (hit != 0)

        if omega <= 1.0:
            def cond(c):
                total, dist, steps = c
                return (steps < max_steps) & _any(live(total, dist))

            def body(c):
                total, dist, steps = c
                active = live(total, dist)
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
            # Over-relaxed sphere tracing (Keinert et al.): step omega*d;
            # when consecutive step spheres stop overlapping
            # (s_prev > d_prev + d) the relaxed step may have skipped
            # surface, so revert to the plain step from the previous
            # point (that eval is wasted). `dist` tracks the last SAFE
            # evaluation only — an overshot point can sit past the
            # surface with small |d|, which must not read as a hit.
            def cond(c):
                total, dist, s_prev, d_prev, steps = c
                return (steps < max_steps) & _any(live(total, dist))

            def body(c):
                total, dist, s_prev, d_prev, steps = c
                active = live(total, dist)
                d = eval_d(total)
                unsafe = s_prev > d_prev + d
                t_revert = total - s_prev + d_prev
                step = omega * d
                # a relaxed leap past the bounds exit must not turn a
                # plain-step survivor into a spurious miss
                step = jnp.where(total + step > tmax, d, step)
                return (
                    jnp.where(
                        active,
                        jnp.where(unsafe, t_revert, total + step),
                        total,
                    ),
                    jnp.where(active & ~unsafe, d, dist),
                    jnp.where(
                        active, jnp.where(unsafe, d_prev, step), s_prev
                    ),
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
        o_total[:] = total
        o_dist[:] = dist

    return kernel


@functools.partial(jax.jit, static_argnames=("est_key", "max_steps", "interpret"))
def _march_call(local_origin, direction, t0, tmax, hit, *, est_key, max_steps, interpret=False):
    """est_key: hashable static encoding of the estimator parameters (the
    kernel is specialized and cached per scene shape)."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as pl_triton

    est = dict(est_key)
    if est.get("constant") is not None:
        est["constant"] = tuple(est["constant"])

    n = local_origin.shape[0]
    block = MARCH_BLOCK
    pad = (-n) % block
    if pad:
        local_origin = jnp.concatenate([local_origin, jnp.zeros((pad, 3))])
        direction = jnp.concatenate([direction, jnp.ones((pad, 3))])
        t0 = jnp.concatenate([t0, jnp.zeros(pad)])
        tmax = jnp.concatenate([tmax, jnp.zeros(pad)])
        hit = jnp.concatenate([hit, jnp.zeros(pad, hit.dtype)])
    np_ = n + pad

    lane = pl.BlockSpec((block,), lambda i: (i,))
    out = pl.pallas_call(
        _make_march_kernel(est, max_steps),
        grid=(np_ // block,),
        in_specs=[lane] * 9,
        out_specs=[lane] * 2,
        out_shape=[jax.ShapeDtypeStruct((np_,), jnp.float32)] * 2,
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=MARCH_WARPS, num_stages=1),
        interpret=interpret,
        name="de_march",
    )(
        local_origin[:, 0], local_origin[:, 1], local_origin[:, 2],
        direction[:, 0], direction[:, 1], direction[:, 2],
        t0, tmax, hit,
    )
    if pad:
        out = [x[:n] for x in out]
    return tuple(out)


def estimator_key(est: dict):
    """Hashable static encoding of a DE shape's estimator parameters."""
    items = []
    for k, v in sorted(est.items()):
        if isinstance(v, (list, tuple, np.ndarray)):
            items.append((k, tuple(float(x) for x in np.asarray(v).ravel())))
        else:
            items.append((k, v))
    return tuple(items)


def de_omega() -> float:
    """Over-relaxation factor for the DE sphere trace (Keinert et al.
    step-back scheme; 1.0 = plain march). Applied identically in the
    kernel and tracer._intersect_de's XLA march so the parity test stays
    tight. 1.6 was the best of a sweep on the cornell scene."""
    return float(os.environ.get("PYRITE_TPU_DE_OMEGA", "1.6"))


def march_de(est: dict, local_origin, direction, t0, tmax, hit, max_steps):
    """Kernel sphere-trace march. Returns (total, dist) like the tail state
    of tracer._intersect_de's while loop. Runs the compiled kernel, or the
    interpreter when ``use_path("interpret")`` asks for it."""
    interpret = _interpret("march")
    key = estimator_key(est)
    omega = de_omega()
    if omega != 1.0:
        key = key + (("omega", omega),)
    return _march_call(
        local_origin, direction, t0,
        jnp.where(hit, tmax, 0.0),
        hit.astype(jnp.int32),
        est_key=key, max_steps=max_steps, interpret=interpret,
    )


# ---- wide-BVH leaf sweep ------------------------------------------------------
#
# The closest-hit / shadow test of the leaf clusters a traversal round has
# parked its lanes on (tracer._cluster_leaf_closest semantics). Each program
# takes SWEEP_BLOCK lanes and gathers its lanes' leaves itself from the
# channel-major geometry table [slots * 12, L] (row leaf * 12 + c holds
# channel c of the leaf's L primitives), one SWEEP_TILE-wide tile at a time.

# 8-64 lanes with 4 or 8 warps measured within 13% of each other on the
# H100; 16 lanes / 8 warps was the fastest (PERF.md).
SWEEP_BLOCK = 16
SWEEP_WARPS = 8
SWEEP_TILE = 128

# primitive kind / hit kind codes (scene.PRIM_*, tracer.KIND_*; literals to
# avoid a scene <-> kernels import cycle)
_PRIM_TRIANGLE = 0.0
_PRIM_SPHERE = 1.0
_KIND_TRIANGLE = 1
_KIND_SPHERE = 2


def pack_geo_channel_major(packed_geo: np.ndarray) -> np.ndarray:
    """[slots, L, 12] prim-major leaf geometry -> [slots * 12, L]."""
    slots, leaf, ch = packed_geo.shape
    return np.ascontiguousarray(np.transpose(packed_geo, (0, 2, 1))).reshape(
        slots * ch, leaf
    )


def _sweep_tile(geo_ref, ids, start, ray, act):
    """Ray tests of one SWEEP_TILE-wide tile of each lane's leaf: returns
    (t [B, T] with inf for misses, is_tri, u, v, prim ref). Moller-Trumbore
    and the sphere root as geometry.ray_triangle / ray_sphere."""
    from jax.experimental import pallas as pl

    rows = ids * 12
    ch = lambda c: geo_ref[rows + c, pl.ds(start, SWEEP_TILE)]
    ox, oy, oz, dx, dy, dz = (x[:, None] for x in ray)
    cx, cy, cz = ch(0), ch(1), ch(2)  # v0 (triangles) / centre (spheres)
    e1x, e1y, e1z = ch(3), ch(4), ch(5)
    e2x, e2y, e2z = ch(6), ch(7), ch(8)
    kind = ch(10)

    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    tri_ok = jnp.abs(det) > _DIST_EPS
    inv_det = 1.0 / jnp.where(tri_ok, det, 1.0)
    tvx, tvy, tvz = ox - cx, oy - cy, oz - cz
    u = (tvx * px + tvy * py + tvz * pz) * inv_det
    tri_ok &= (u >= 0.0) & (u <= 1.0)
    qx = tvy * e1z - tvz * e1y
    qy = tvz * e1x - tvx * e1z
    qz = tvx * e1y - tvy * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    tri_ok &= (v >= 0.0) & (u + v <= 1.0)
    tri_t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    tri_ok &= tri_t > _DIST_EPS

    lx, ly, lz = cx - ox, cy - oy, cz - oz
    tca = lx * dx + ly * dy + lz * dz
    d2 = lx * lx + ly * ly + lz * lz - tca * tca
    radius = ch(9)
    r2 = radius * radius
    sph_ok = d2 <= r2
    thc = jnp.sqrt(jnp.maximum(r2 - d2, 0.0))
    t0 = tca - thc
    sph_t = jnp.where(t0 > _DIST_EPS, t0, tca + thc)
    sph_ok &= sph_t > _DIST_EPS

    is_tri = kind == _PRIM_TRIANGLE
    ok = jnp.where(is_tri, tri_ok, sph_ok & (kind == _PRIM_SPHERE))
    ok &= act[:, None] != 0
    t = jnp.where(ok, jnp.where(is_tri, tri_t, sph_t), jnp.inf)
    return t, is_tri, u, v, ch(11)


def _make_sweep_kernel(q_slots, leaf, shadow):
    n_state = 1 if shadow else 5

    def kernel(geo_ref, *refs):
        ids_refs = refs[:q_slots]
        act_refs = refs[q_slots : 2 * q_slots]
        ray = tuple(r[:] for r in refs[2 * q_slots : 2 * q_slots + 6])
        state_refs = refs[2 * q_slots + 6 : 2 * q_slots + 6 + n_state]
        out_refs = refs[2 * q_slots + 6 + n_state :]
        state = [r[:] for r in state_refs]
        for q in range(q_slots):
            ids, act = ids_refs[q][:], act_refs[q][:]
            for start in range(0, leaf, SWEEP_TILE):
                t, is_tri, u, v, ref = _sweep_tile(geo_ref, ids, start, ray, act)
                tq = jnp.min(t, axis=1)
                if shadow:
                    state[0] = jnp.minimum(state[0], tq)
                    continue
                # first column achieving the minimum; strict < across tiles
                # keeps the earliest winner on ties (a row-major first-min)
                col = jax.lax.broadcasted_iota(jnp.int32, t.shape, 1)
                sel = jnp.min(jnp.where(t == tq[:, None], col, SWEEP_TILE), axis=1)
                first = col == sel[:, None]
                pick = lambda x: jnp.sum(jnp.where(first, x, 0.0), axis=1)
                better = tq < state[0]
                won_tri = pick(is_tri.astype(jnp.float32)) > 0.5
                state = [
                    jnp.where(better, tq, state[0]),
                    jnp.where(
                        better,
                        jnp.where(won_tri, _KIND_TRIANGLE, _KIND_SPHERE),
                        state[1],
                    ),
                    jnp.where(better, pick(ref).astype(jnp.int32), state[2]),
                    jnp.where(better, pick(u), state[3]),
                    jnp.where(better, pick(v), state[4]),
                ]
        for r, x in zip(out_refs, state):
            r[:] = x

    return kernel


@functools.partial(jax.jit, static_argnames=("leaf", "shadow", "interpret"))
def _sweep_call(geo_ch, leaf_ids, active, origin, direction, state_vals, *, leaf, shadow, interpret=False):
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as pl_triton

    n, q_slots = leaf_ids.shape
    block = SWEEP_BLOCK
    pad = (-n) % block
    lanes = (
        [leaf_ids[:, q] for q in range(q_slots)]
        + [active[:, q].astype(jnp.int32) for q in range(q_slots)]
        + [origin[:, k] for k in range(3)]
        + [direction[:, k] for k in range(3)]
        + list(state_vals)
    )
    if pad:
        lanes = [jnp.concatenate([x, jnp.zeros(pad, x.dtype)]) for x in lanes]
    np_ = n + pad
    lane = pl.BlockSpec((block,), lambda i: (i,))
    out = pl.pallas_call(
        _make_sweep_kernel(q_slots, leaf, shadow),
        grid=(np_ // block,),
        in_specs=[pl.BlockSpec(geo_ch.shape, lambda i: (0, 0))] + [lane] * len(lanes),
        out_specs=[lane] * len(state_vals),
        out_shape=[jax.ShapeDtypeStruct((np_,), x.dtype) for x in state_vals],
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=SWEEP_WARPS, num_stages=1),
        interpret=interpret,
        name="leaf_sweep_shadow" if shadow else "leaf_sweep",
    )(geo_ch, *lanes)
    return tuple(x[:n] for x in out)


def sweep(geo_ch, cluster_leaf, leaf_ids, active, origin, direction, state, shadow):
    """Kernel leaf sweep with tracer._cluster_leaf_closest / _shadow's
    signature and results. Path rule as march_de."""
    interpret = _interpret("sweep")
    keys = ("t",) if shadow else ("t", "kind", "idx", "u", "v")
    out = _sweep_call(
        geo_ch, leaf_ids, active, origin, direction,
        [state[k] for k in keys],
        leaf=cluster_leaf, shadow=shadow, interpret=interpret,
    )
    return dict(zip(keys, out))
