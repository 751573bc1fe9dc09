"""Bidirectional path tracing (reference: renderer/bidirectional.rs).

Per pixel sample the reference traces a camera path and a lamp path, then
(a) contributes the camera path like the simple renderer,
(b) connects every diffuse camera vertex to every lamp vertex with a
    visibility ray (connect_paths, bidirectional.rs:310-398), and
(c) splats every diffuse lamp vertex through the camera lens
    (light tracing, bidirectional.rs:253-306).

Wavefront formulation: lamp paths are recorded as fixed-capacity [N, L+1] vertex
arrays with validity masks, and the repeated suffix walks of connect_paths
collapse to *prefix products* along the lamp path: walking lamp_path[i..]
multiplies color*probability*brdf per vertex and ends at the emitter, so the
connection radiance for forward vertex F is PP_F(lambda) = emitter_radiance *
prod_{k<=F}(color_k prob_k brdf_k) — computed once per path with a cumprod
instead of O(L^2) re-walks. Two reference details worth noting: the
brdf_in "ratio" of connect_paths is identically 1 (the lambertian only dots
its last two arguments, so numerator and denominator coincide), and each
connection sample carries a copy of the camera-side radiance accumulated so
far, exposed at weight 1/(len_cam*len_lamp) — both reproduced exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..exprs import ProgramInputs
from ..film import Film, expose_sums
from ..scene import CameraModel, Scene, camera_inverse_project
from ..tracer import (
    DIST_EPSILON,
    TraceConfig,
    bounce_core,
    eval_color_bank,
    intersect_scene,
    intersect_shadow,
    merged_queries,
    merged_traversal_enabled,
    trace_direct_post,
    trace_lamp_path,
)
from .simple import RenderProgress, chunk_order, chunk_rays, regen_enabled

# cap on lanes*(L+1)*S to keep lamp-path arrays within memory
_LANE_BUDGET = 48_000_000
# byte cap on the regen-BDPT camera walk's stacked [n, R, K'] connection
# trees (R rounds flush early when realized lamp lengths make K' large;
# see _render_regen_bdpt)
import os as _os

_CONN_STACK_BUDGET = int(
    _os.environ.get("PYRITE_TPU_CONN_STACK_BUDGET", str(1 << 30))
)


def _effective_brdf(path):
    """Per-slot brdf: recorded 2|n.incident| except a trailing limit-ended
    vertex, which keeps its scattered out-direction's brdf."""
    slots = path["valid"].shape[1]
    brdf = path["brdf"]
    if "brdf_limit" in path:
        brdf = brdf.at[:, slots - 1].set(
            jnp.where(
                path["valid"][:, slots - 1],
                path["brdf_limit"],
                brdf[:, slots - 1],
            )
        )
    return brdf


def _lamp_path_factors(scene: Scene, path, wavelengths, cfg: TraceConfig):
    """Per-vertex radiance prefix products PP [N, L+1, S], aux-validity
    prefix A [N, L+1], and specular flags."""
    n, slots = path["valid"].shape
    s_count = wavelengths.shape[1]

    # evaluation inputs per vertex, flattened to [(L+1)*N]
    # incident after the reference's pairs() reversal: vertex j sees
    # -(arrival direction of vertex j+1); the trailing limit-ended vertex
    # keeps its own arrival direction (bidirectional.rs:187-192).
    inc = jnp.concatenate(
        [-path["incident_out"][:, 1:], path["incident_out"][:, -1:]], axis=1
    )
    inc = inc.at[:, slots - 1].set(
        jnp.where(
            path["valid"][:, slots - 1, None],
            path["incident_out"][:, slots - 1],
            inc[:, slots - 1],
        )
    )

    flat = lambda x: x.reshape((n * slots,) + x.shape[2:])
    wl_rep = jnp.repeat(wavelengths[:, None, :], slots, axis=1).reshape(
        n * slots, s_count
    )
    inputs = ProgramInputs(
        wavelength=wl_rep,
        normal=flat(path["normal"]),
        incident=flat(inc),
        uv=flat(path["uv"]),
    )
    color = eval_color_bank(
        scene, flat(path["color_prog"]), inputs, active=flat(path["valid"])
    ).reshape(n, slots, s_count)

    brdf = _effective_brdf(path)

    factor = color * (path["probability"] * brdf)[:, :, None]
    # emitter slot (0) has brdf 1 already; invalid slots contribute factor 1
    factor = jnp.where(path["valid"][:, :, None], factor, 1.0)
    pp = jnp.cumprod(factor, axis=1)

    aux_ok = jnp.cumprod((~path["dispersed"]).astype(jnp.int32), axis=1) > 0

    is_specular = path["valid"] & ~path["is_diffuse"]
    is_specular = is_specular.at[:, 0].set(False)  # the emitter connects
    return pp, aux_ok, is_specular, inc


def _connection_arrays(scene, path, wavelengths, cfg, k_splat):
    """Everything the camera walk needs per lamp slot, as one dict.

    Built at full [N, L+1] capacity; _compact_connections can then gather it
    down to only the *connectable* slots (valid non-specular vertices: the
    emitter and diffuse vertices — connect_paths and the light-tracing pass
    skip specular vertices, bidirectional.rs:270,330). Splat PRNG draws are
    made here per ORIGINAL slot index so a compacted walk is draw-for-draw
    identical to the full-width walk."""
    pp, aux_ok, lamp_specular, _ = _lamp_path_factors(scene, path, wavelengths, cfg)
    n, slots = path["valid"].shape
    splat_u = jnp.stack(
        [
            jax.random.uniform(jax.random.fold_in(k_splat, k), (n, 2))
            for k in range(slots)
        ],
        axis=1,
    )  # [N, K, 2]
    conn_ok = path["valid"] & ~lamp_specular
    return {
        "position": path["position"],
        "normal": path["normal"],
        "pp": pp,
        "aux_ok": aux_ok,
        "conn_ok": conn_ok,
        "splat_ok": path["valid"] & path["is_diffuse"],
        "splat_u": splat_u,
        "length": path["length"],
    }


def connectable_count(conn):
    """Max connectable slots in any lane — the host reads this to bucket the
    compacted capacity (render()'s two-phase path)."""
    return jnp.max(jnp.sum(conn["conn_ok"].astype(jnp.int32), axis=1))


def _compact_connections(conn, k_new: int):
    """Gather the connectable slots of ``conn`` into [N, k_new] arrays
    (stable slot order via a masked-index sort along the slot axis). With
    deep light budgets (dragon/snowflake run light_bounces = 256) almost
    every slot is specular or invalid, so the per-camera-bounce connection
    shadow batch shrinks from N*(L+1) to N*k_new lanes."""
    n, slots = conn["conn_ok"].shape
    idx = jnp.arange(slots)[None, :]
    order_key = jnp.where(conn["conn_ok"], idx, slots + idx)
    order = jnp.argsort(order_key, axis=1)[:, :k_new]  # [N, k_new]
    kept = jnp.take_along_axis(order_key, order, axis=1) < slots

    def take(x):
        o = order
        while o.ndim < x.ndim:
            o = o[..., None]
        return jnp.take_along_axis(x, jnp.broadcast_to(o, x.shape[:1] + (k_new,) + x.shape[2:]), axis=1)

    return {
        "position": take(conn["position"]),
        "normal": take(conn["normal"]),
        "pp": take(conn["pp"]),
        "aux_ok": take(conn["aux_ok"]) & kept,
        "conn_ok": take(conn["conn_ok"]) & kept,
        "splat_ok": take(conn["splat_ok"]) & kept,
        "splat_u": take(conn["splat_u"]),
        "length": conn["length"],
    }


def _splat_shadow_cap(scene) -> int:
    """Max lanes per splat shadow traversal. Cluster scenes bound the
    flattened batch so one traversal keeps the tuned sweep width
    (CLUSTER_LANE_CAP * COMPACT_DIV lanes -> width = CLUSTER_LANE_CAP);
    dense scenes keep the single batched query."""
    if not scene.use_clusters:
        return 1 << 62
    from ..tracer import CLUSTER_LANE_CAP, COMPACT_DIV, aligned_chunk_rows

    # route through the centralized alignment guard: the tuned cap is
    # already 1024-aligned, but every top-level dispatch width must stay on
    # the invariant even if the env knobs change it
    return aligned_chunk_rows(CLUSTER_LANE_CAP * COMPACT_DIV)


def _light_splats(scene, film, camera, cfg, conn, wavelengths, acc, wt, scale_lanes=None):
    """Light-tracing splats (bidirectional.rs:253-306).

    All lamp slots are projected and shadow-tested in ONE flattened
    [N*(L+1)] batch and exposed with a single film scatter (the reference's
    per-vertex loop costs (L+1) serial dispatch rounds on this machine).

    ``scale_lanes`` ([N] float): per-lane splat multiplicity (the number of
    camera samples a lamp path serves — 1 per round under the regen
    scheduler, 0 for rounds beyond a device's sample target). Exposing a
    splat once with weight (and value) scaled by that count is exactly
    equivalent to exposing it once per sample, preserving the reference's
    per-sample technique mix in the film's weighted average."""
    n, slots = conn["conn_ok"].shape
    s_count = wavelengths.shape[1]
    len_lamp = jnp.maximum(conn["length"], 1)
    splat_weight = 1.0 / len_lamp.astype(jnp.float32)
    if scale_lanes is not None:
        splat_weight = splat_weight * scale_lanes
    pp, aux_ok, u = conn["pp"], conn["aux_ok"], conn["splat_u"]

    flat = lambda x: x.reshape((n * slots,) + x.shape[2:])
    mask = flat(conn["splat_ok"])
    view_xy, world_origin, direction, distance, ok = camera_inverse_project(
        camera, flat(conn["position"]), flat(u[..., 0]), flat(u[..., 1])
    )
    mask &= ok
    mask &= (jnp.abs(view_xy[:, 0]) < 1.0) & (jnp.abs(view_xy[:, 1]) < 1.0)

    m = world_origin.shape[0]
    cap = _splat_shadow_cap(scene)
    if m <= cap:
        t_hit = intersect_shadow(
            scene, world_origin, direction, cfg,
            max_dist=distance, block_below=distance - DIST_EPSILON,
        )
    elif conn_ragged_enabled():
        # Deep lamp budgets flatten to multi-million-query batches
        # (dragon: 16k lanes x 257 slots = 4.2M) of which only
        # ~mean-lamp-length x frustum-visible are real splats (about 2 of
        # 257 at dragon scale). Compact the REAL queries first and walk
        # only ceil(count/cap) chunks instead of sweeping inert padding:
        # one argsort replaces most of the walks.
        order = jnp.argsort(~mask, stable=True)
        count = jnp.sum(mask.astype(jnp.int32))
        pad = (-m) % cap
        widths = lambda x: [(0, pad)] + [(0, 0)] * (x.ndim - 1)  # noqa: E731
        o_s = jnp.pad(world_origin[order], widths(world_origin))
        d_s = jnp.pad(direction[order], widths(direction), constant_values=1.0)
        dist_s = jnp.pad(distance[order] * mask[order], widths(distance))
        t_s = jnp.full(m + pad, jnp.inf)
        active = (count + cap - 1) // cap

        def body(carry):
            i, t_s = carry
            q0 = i * cap
            take = lambda x: jax.lax.dynamic_slice_in_dim(x, q0, cap)  # noqa: E731
            dist_c = take(dist_s)
            t_c = intersect_shadow(
                scene, take(o_s), take(d_s), cfg,
                max_dist=dist_c, block_below=dist_c - DIST_EPSILON,
            )
            return i + 1, jax.lax.dynamic_update_slice_in_dim(t_s, t_c, q0, 0)

        _, t_s = jax.lax.while_loop(
            lambda c: c[0] < active, body, (jnp.int32(0), t_s)
        )
        t_hit = jnp.full(m, jnp.inf).at[order].set(t_s[:m])
    else:
        # dense chunk ladder (PYRITE_TPU_CONN_RAGGED=0): lax.map compiles
        # ONE cap-wide traversal and runs the chunks sequentially (inert
        # padding lanes seed distance 0, so the root slab test rejects
        # every subtree and they never park).
        pad = (-m) % cap
        padded = lambda x, v: jnp.concatenate(  # noqa: E731
            [x, jnp.full((pad,) + x.shape[1:], v, x.dtype)]
        )
        o_c = padded(world_origin, 0.0).reshape(-1, cap, 3)
        d_c = padded(direction, 1.0).reshape(-1, cap, 3)
        dist_c = padded(distance, 0.0).reshape(-1, cap)

        def one_chunk(args):
            o, d, dist = args
            return intersect_shadow(
                scene, o, d, cfg,
                max_dist=dist, block_below=dist - DIST_EPSILON,
            )

        t_hit = jax.lax.map(one_chunk, (o_c, d_c, dist_c)).reshape(-1)[:m]
    mask &= ~(jnp.isfinite(t_hit) & (t_hit < distance - DIST_EPSILON))

    scale = 1.0 / jnp.maximum(distance * distance, 1e-20)
    brightness = flat(pp) * scale[:, None]  # [N*K, S]

    cols = jnp.concatenate(
        [
            jnp.ones((n * slots, 1), bool),
            jnp.broadcast_to(flat(aux_ok)[:, None], (n * slots, s_count - 1)),
        ],
        axis=1,
    )
    weights = jnp.broadcast_to(
        jnp.repeat(splat_weight, slots)[:, None], (n * slots, s_count)
    )
    wl_rep = jnp.repeat(wavelengths[:, None, :], slots, axis=1).reshape(
        n * slots, s_count
    )
    acc, wt = film.expose(
        acc, wt, view_xy, wl_rep, brightness, weights, mask[:, None] & cols
    )
    return acc, wt


# slots per connection-query group: deep lamp budgets realize K' = 256
# compacted slots, and one flattened [n*K'] shadow traversal plus its
# [n, K', S] fold temps dominates the camera walk's memory (dragon-class:
# 8.4M-lane queries pushed cam_step to a 20 GB compile OOM). Groups of G
# slots run sequentially under lax.map: ONE compiled [n*G] query, bounded
# transients, identical folded sums (the fold is a sum over slots).
_CONN_GROUP_SLOTS = int(_os.environ.get("PYRITE_TPU_CONN_GROUP", "64"))
# run slot groups as an unrolled Python loop instead of lax.map (the map
# nests a scan around the cluster walk's while/fori inside the camera
# while_loop)
_CONN_UNROLL = int(_os.environ.get("PYRITE_TPU_CONN_UNROLL", "0"))
# debugging knob: skip the connection fold inside the camera walk entirely
# (WRONG IMAGE — isolates the cost of the grouped connection shadow walks
# inside the regen while-loop)
_BDPT_NOCONN = int(_os.environ.get("PYRITE_TPU_BDPT_NOCONN", "0"))
# deferred connections (cluster regen walks): instead of folding every lamp
# slot against every lane at EVERY regen iteration (iters x n x K' shadow
# rays, all dispatched inside the while-loop), the walk only RECORDS its
# diffuse vertices ([n, R, V] ring buffers in the carry) and the finish
# step runs all connection batches top-level over the compacted vertex
# list — the proven-safe splat structure. Work drops from iters*n*K' to
# sum(len_cam)*K' shadow rays (~5-10x on dragon-class mean path lengths),
# identical math (same fold, reassociated sums). DEFAULT ON: the in-loop
# grouped fold's per-iteration shadow walks dominate dragon-class scenes
# (871k tris, 256 light bounces). CPU parity: test_renderers.py
# inline-vs-deferred.
_CONN_DEFER = int(_os.environ.get("PYRITE_TPU_CONN_DEFER", "1"))


def _connect_fold_grouped(
    scene, cfg, info, new_state, position, normal, conn_ok, pp, aux_ok,
    conn_vsum, conn_cnt,
):
    """Connection query + occlusion + fold over slot groups (see
    _CONN_GROUP_SLOTS). Padded slots mirror ordinary non-connectable slots
    (position 0, conn_ok False), so they fold to zero exactly."""
    n, slots = conn_ok.shape
    # bound the flattened [n*g] shadow traversal to the splat path's cap
    # (CLUSTER_LANE_CAP * COMPACT_DIV): an unbounded group at dragon widths
    # (16k lanes x 64 slots = 1M) walks the BVH 4x over the tuned sweep
    # width and allocates multi-GB per-pop intermediates.
    g = min(_CONN_GROUP_SLOTS, max(1, _splat_shadow_cap(scene) // n))

    def run(pos_k, nor_k, ok_k, pp_k, aux_k, k):
        query, pack = _conn_query(info, pos_k, nor_k, ok_k)
        t_hit = intersect_shadow(
            scene, query["origin"], query["direction"], cfg,
            max_dist=query["max_dist"], block_below=query["block_below"],
        )
        blocked = _conn_blocked(t_hit, query, n, k)
        return _conn_fold(
            new_state, info, pack, blocked, pp_k, aux_k,
            jnp.zeros_like(conn_vsum), jnp.zeros_like(conn_cnt),
        )

    if slots <= g:
        vs, cn = run(position, normal, conn_ok, pp, aux_ok, slots)
        return conn_vsum + vs, conn_cnt + cn

    pad = (-slots) % g

    def padk(x, v):
        if pad == 0:
            return x
        widths = [(0, 0)] * x.ndim
        widths[1] = (0, pad)
        return jnp.pad(x, widths, constant_values=v)

    ng = (slots + pad) // g

    def grouped(x):
        return jnp.moveaxis(x.reshape((n, ng, g) + x.shape[2:]), 1, 0)

    args = (
        grouped(padk(position, 0.0)),
        grouped(padk(normal, 0.0)),
        grouped(padk(conn_ok, False)),
        grouped(padk(pp, 0.0)),
        grouped(padk(aux_ok, False)),
    )
    if _CONN_UNROLL:
        for gi in range(ng):
            vs, cn = run(*(a[gi] for a in args), g)
            conn_vsum = conn_vsum + vs
            conn_cnt = conn_cnt + cn
        return conn_vsum, conn_cnt
    vss, cns = jax.lax.map(lambda a: run(a[0], a[1], a[2], a[3], a[4], g), args)
    return conn_vsum + vss.sum(axis=0), conn_cnt + cns.sum(axis=0)


def _conn_query(info, conn_position, conn_normal, conn_ok):
    """Connection-batch geometry + candidate masks (pre-occlusion): the
    flattened [N*K] shadow query over every lamp slot, in the shadow-query
    shape merged_queries/intersect_shadow share. Returns (query, pack);
    pack carries the geometry terms _conn_fold needs after the verdict."""
    n, slots = conn_ok.shape
    dirvec = conn_position - info["position"][:, None, :]  # [N,K,3]
    sqd = jnp.sum(dirvec * dirvec, axis=-1)
    dist = jnp.sqrt(jnp.maximum(sqd, 1e-20))
    conn_dir = dirvec / dist[..., None]

    cos_out_s = jnp.sum(info["normal"][:, None, :] * conn_dir, axis=-1)
    cos_in_s = jnp.sum(conn_normal * -conn_dir, axis=-1)
    good = info["is_diffuse"][:, None] & conn_ok
    good &= cos_out_s > 0.0
    good &= cos_in_s > 0.0

    flat = lambda x: x.reshape((n * slots,) + x.shape[2:])
    origin_f = jnp.broadcast_to(info["position"][:, None, :], (n, slots, 3))
    dist_f = flat(dist)
    query = {
        "origin": flat(origin_f),
        "direction": flat(conn_dir),
        "max_dist": dist_f,
        "block_below": dist_f - DIST_EPSILON,
        "contributes": flat(good),
    }
    pack = {
        "good": good, "sqd": sqd,
        "cos_out_s": cos_out_s, "cos_in_s": cos_in_s,
    }
    return query, pack


def _conn_blocked(t_hit, query, n, slots):
    """Occlusion verdict for a flattened connection batch -> [N, K]."""
    return (
        jnp.isfinite(t_hit) & (t_hit < query["max_dist"] - DIST_EPSILON)
    ).reshape(n, slots)


def _conn_fold(new_state, info, pack, blocked, pp, aux_ok, conn_vsum, conn_cnt):
    """Fold connection verdicts into the per-lane sums (connect_paths math,
    bidirectional.rs:310-398). Uses new_state's brightness AFTER the
    bounce's NEE delta, matching the in-line evaluation order."""
    n, slots = blocked.shape
    s_count = new_state["brightness"].shape[1]
    good = pack["good"] & ~blocked
    brdf_conn = 2.0 * jnp.abs(pack["cos_out_s"])
    brdf_ratio = brdf_conn / jnp.maximum(info["brdf_stored"][:, None], 1e-20)
    scale = (
        jnp.abs(pack["cos_in_s"])
        * jnp.abs(pack["cos_out_s"])
        * brdf_ratio
        / (2.0 * jnp.pi * jnp.maximum(pack["sqd"], 1e-20))
    )

    delta = new_state["reflectance"][:, None, :] * scale[..., None] * pp
    value = new_state["brightness"][:, None, :] + delta  # [N, K, S]

    aux_take = new_state["aux_alive"][:, None] & aux_ok  # [N, K]
    cols = jnp.concatenate(
        [
            jnp.ones((n, slots, 1), bool),
            jnp.broadcast_to(aux_take[..., None], (n, slots, s_count - 1)),
        ],
        axis=2,
    )
    take = good[..., None] & cols
    return (
        conn_vsum + jnp.sum(jnp.where(take, value, 0.0), axis=1),
        conn_cnt + jnp.sum(take.astype(jnp.float32), axis=1),
    )


def conn_ragged_enabled() -> bool:
    """Pair-level (ragged) packing for the deferred connection chunks.
    Default on: chunk walks sweep exactly sum(connectable slots) flattened
    queries instead of count * K' — at dragon scale the mean lamp-path
    connectable count is far below the compacted max K', so the chunk
    count (each a seconds-long cap-wide shadow walk) collapses by the
    K'/mean ratio. PYRITE_TPU_CONN_RAGGED=0 restores the vertex sweep."""
    return _os.environ.get("PYRITE_TPU_CONN_RAGGED", "1") != "0"


def _deferred_connections(scene, cfg, conn_r, vbuf):
    """Connection occlusion + fold for RECORDED camera vertices, batched
    top-level (the splat structure: chunked cap-wide shadow walks outside
    any camera loop). ``vbuf``: [n, R, V] per-(lane, round, vertex) ring
    buffers written by the regen walk. Vertices are compacted (valid
    first) so only ~sum(len_cam) of the n*R*V capacity pays traversal —
    a dynamic-trip while loop walks just the active chunks; the last
    partial chunk is padded inert. Returns per-(lane, round) connection
    sums [n, R, S] identical to the in-loop fold's (reassociated)."""
    slots = conn_r["conn_ok"].shape[2]
    rows = _deferred_rows(scene, slots)
    n = vbuf["valid"].shape[0]
    s = vbuf["refl"].shape[-1]
    r_count = vbuf["valid"].shape[1]

    if conn_ragged_enabled():
        packed = _deferred_pack(vbuf, rows, conn_r=conn_r)
        q_width = rows * slots
        active = (packed["pair_total"] + q_width - 1) // q_width

        def body(carry):
            i, vsum, cnt = carry
            vsum, cnt = _ragged_chunk(
                scene, cfg, conn_r, packed, q_width, i, vsum, cnt
            )
            return i + 1, vsum, cnt
    else:
        packed = _deferred_pack(vbuf, rows)
        count = packed["count"]
        active = (count + rows - 1) // rows  # dynamic chunk count

        def body(carry):
            i, vsum, cnt = carry
            vsum, cnt = _deferred_chunk(
                scene, cfg, conn_r, packed, rows, i, vsum, cnt
            )
            return i + 1, vsum, cnt

    _, vsum, cnt = jax.lax.while_loop(
        lambda c: c[0] < active,
        body,
        (jnp.int32(0), jnp.zeros((n, r_count, s)), jnp.zeros((n, r_count, s))),
    )
    return vsum, cnt


def _deferred_rows(scene, slots: int) -> int:
    """Vertices per connection chunk: near the splat cap, with the
    flattened query width (rows * slots) rounded by the shared launch
    alignment (tracer.aligned_chunk_rows)."""
    from ..tracer import aligned_chunk_rows

    return aligned_chunk_rows(max(1, _splat_shadow_cap(scene) // slots), slots)


def _deferred_pack(vbuf, rows, conn_r=None):
    """Compaction half of the deferred-connection fold: flatten the
    [n, R, V] ring buffers and stable-sort valid vertices first (``rows``
    = vertices per chunk, from _deferred_rows). Returns the packed arrays
    plus the valid count so a host driver can run the chunk walks as
    bounded separate launches (_deferred_chunk) instead of one unbounded
    in-jit while loop: a dragon-scale finish is a data-dependent-length
    launch of more than a minute.

    With ``conn_r`` the pack additionally carries the PAIR prefix sums for
    the ragged chunk layout (_ragged_chunk): each packed vertex's
    connectable-slot count (conn_ok is a valid-first prefix after
    _compact_connections) cumulated over the packed order."""
    n, r_count, v_cap = vbuf["valid"].shape
    m = n * r_count * v_cap
    m_pad = ((m + rows - 1) // rows) * rows

    def flat(x):
        x = x.reshape((m,) + x.shape[3:])
        widths = [(0, m_pad - m)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, widths)

    valid = flat(vbuf["valid"])
    # stable compaction: valid vertices first, original order preserved
    order = jnp.argsort(~valid, stable=True)
    idx = jnp.arange(m_pad, dtype=jnp.int32)
    lane_of = jnp.where(idx < m, idx // (r_count * v_cap), 0)
    round_of = jnp.where(idx < m, (idx // v_cap) % r_count, 0)
    packed = {
        f: flat(vbuf[f])[order]
        for f in ("pos", "nor", "refl", "bright", "brdf", "aux")
    }
    packed["lane"] = lane_of[order]
    packed["round"] = round_of[order]
    packed["valid"] = valid[order]
    packed["count"] = jnp.sum(valid.astype(jnp.int32))
    if conn_r is not None:
        conn_counts = jnp.sum(conn_r["conn_ok"].astype(jnp.int32), axis=2)
        per_vertex = jnp.where(
            packed["valid"],
            conn_counts[packed["lane"], packed["round"]],
            0,
        )
        cum = jnp.cumsum(per_vertex)
        packed["pair_cum"] = jnp.concatenate(
            [jnp.zeros(1, cum.dtype), cum]
        )  # [m_pad + 1]
        packed["pair_total"] = cum[-1]
    return packed


def _ragged_chunk(scene, cfg, conn_r, packed, q_width, i, vsum, cnt):
    """One RAGGED connection chunk: occlusion + fold for flattened
    (vertex, connectable-slot) PAIRS [i*q_width, (i+1)*q_width). The query
    budget is spent only on real connections — sum(conn counts) total
    queries across a finish instead of count * K' (identical math to
    _deferred_chunk / _conn_fold per pair; each pair's exposure is
    independent, so per-query scatter-adds reassociate the same sums)."""
    n, r_count, s = vsum.shape
    cum = packed["pair_cum"]
    q = i * q_width + jnp.arange(q_width, dtype=cum.dtype)
    live = q < packed["pair_total"]
    vid = jnp.clip(
        jnp.searchsorted(cum, q, side="right") - 1, 0, cum.shape[0] - 2
    )
    k = jnp.clip((q - cum[vid]).astype(jnp.int32), 0,
                 conn_r["conn_ok"].shape[2] - 1)
    vld = live & packed["valid"][vid]
    lane = packed["lane"][vid]
    rnd = packed["round"][vid]
    pos_v = packed["pos"][vid]
    nor_v = packed["nor"][vid]

    cpos = conn_r["position"][lane, rnd, k]
    cnor = conn_r["normal"][lane, rnd, k]
    cok = conn_r["conn_ok"][lane, rnd, k] & vld
    pp = conn_r["pp"][lane, rnd, k]  # [Q, S]
    aux = conn_r["aux_ok"][lane, rnd, k]

    dirvec = cpos - pos_v
    sqd = jnp.sum(dirvec * dirvec, axis=-1)
    dist = jnp.sqrt(jnp.maximum(sqd, 1e-20))
    conn_dir = dirvec / dist[..., None]
    cos_out = jnp.sum(nor_v * conn_dir, axis=-1)
    cos_in = jnp.sum(cnor * -conn_dir, axis=-1)
    good = cok & (cos_out > 0.0) & (cos_in > 0.0)

    # inert rays for non-contributing queries (the splat padding trick);
    # the vertex sweep walked cos-rejected slots too — the verdict is
    # ignored for them, so skipping the walk is output-identical
    dir_q = jnp.where(good[:, None], conn_dir, jnp.array([0.0, 0.0, 1.0]))
    maxd = jnp.where(good, dist, 0.0)
    t_hit = intersect_shadow(
        scene, pos_v, dir_q, cfg,
        max_dist=maxd, block_below=maxd - DIST_EPSILON,
    )
    blocked = jnp.isfinite(t_hit) & (t_hit < maxd - DIST_EPSILON)
    ok = good & ~blocked

    brdf_conn = 2.0 * jnp.abs(cos_out)
    brdf_ratio = brdf_conn / jnp.maximum(packed["brdf"][vid], 1e-20)
    scale = (
        jnp.abs(cos_in) * jnp.abs(cos_out) * brdf_ratio
        / (2.0 * jnp.pi * jnp.maximum(sqd, 1e-20))
    )
    delta = packed["refl"][vid] * scale[:, None] * pp
    value = packed["bright"][vid] + delta  # [Q, S]

    aux_take = packed["aux"][vid] & aux
    cols = jnp.concatenate(
        [
            jnp.ones((q_width, 1), bool),
            jnp.broadcast_to(aux_take[:, None], (q_width, s - 1)),
        ],
        axis=1,
    )
    take = ok[:, None] & cols
    li = jnp.where(vld, lane, n)  # out-of-range rows drop
    return (
        vsum.at[li, rnd].add(jnp.where(take, value, 0.0), mode="drop"),
        cnt.at[li, rnd].add(take.astype(jnp.float32), mode="drop"),
    )


def _deferred_chunk(scene, cfg, conn_r, packed, rows, i, vsum, cnt):
    """One connection chunk: occlusion + fold for packed vertices
    [i*rows, (i+1)*rows), accumulated into per-(lane, round) sums."""
    n = vsum.shape[0]
    s = vsum.shape[-1]
    slots = conn_r["conn_ok"].shape[2]
    p_valid = packed["valid"]
    p_lane = packed["lane"]
    p_round = packed["round"]

    def chunk(i, vsum, cnt):
        q0 = i * rows
        take = lambda x: jax.lax.dynamic_slice_in_dim(x, q0, rows, axis=0)
        vld = take(p_valid)
        lane = take(p_lane)
        rnd = take(p_round)
        info_l = {
            "position": take(packed["pos"]),
            "normal": take(packed["nor"]),
            "is_diffuse": vld,
            "brdf_stored": take(packed["brdf"]),
        }
        state_l = {
            "brightness": take(packed["bright"]),
            "reflectance": take(packed["refl"]),
            "aux_alive": take(packed["aux"]),
        }
        cok = conn_r["conn_ok"][lane, rnd] & vld[:, None]
        query, pack = _conn_query(
            info_l, conn_r["position"][lane, rnd],
            conn_r["normal"][lane, rnd], cok,
        )
        # padded/invalid rows are all-zero geometry (degenerate 0-direction
        # rays): give them an inert unit ray with max_dist 0 so the root
        # slab test rejects every subtree (the splat padding trick)
        vmask = jnp.repeat(vld, slots)
        dir_q = jnp.where(
            vmask[:, None], query["direction"], jnp.array([0.0, 0.0, 1.0])
        )
        maxd = jnp.where(vmask, query["max_dist"], 0.0)
        t_hit = intersect_shadow(
            scene, query["origin"], dir_q, cfg,
            max_dist=maxd, block_below=maxd - DIST_EPSILON,
        )
        blocked = _conn_blocked(t_hit, query, rows, slots)
        vs, cn = _conn_fold(
            state_l, info_l, pack, blocked,
            conn_r["pp"][lane, rnd], conn_r["aux_ok"][lane, rnd],
            jnp.zeros((rows, s)), jnp.zeros((rows, s)),
        )
        li = jnp.where(vld, lane, n)  # out-of-range rows drop
        return (
            vsum.at[li, rnd].add(vs, mode="drop"),
            cnt.at[li, rnd].add(cn, mode="drop"),
        )

    return chunk(i, vsum, cnt)


def make_render_step(
    scene: Scene,
    film: Film,
    camera: CameraModel,
    cfg: TraceConfig,
    light_bounces: int,
    rows_per_chunk: int,
    jit: bool = True,
    two_phase: bool = False,
):
    """``two_phase=False``: one fused chunk step (lamp trace + camera walk),
    the shape render_sharded's shard_map needs. ``two_phase=True``: returns
    (lamp_step, compact_step, cam_step) so the host can read the max
    connectable slot count per chunk and run the camera walk against
    compacted [N, K'] connection arrays — at light_bounces=256 (dragon,
    snowflake) nearly all of the L+1 slots are specular or invalid, so this
    shrinks every per-bounce connection shadow batch by ~K/K'."""
    lamp_cfg = TraceConfig(
        bounces=light_bounces,
        light_samples=0,
        spectrum_samples=cfg.spectrum_samples,
        max_de_steps=cfg.max_de_steps,
    )

    def lamp_step(key, data):
        """Phase 1 of the two-phase path: lamp subpaths -> connection arrays
        (full [N, L+1] capacity) + the max connectable count for bucketing."""
        with scene.bind(data):
            _, _, _, wavelengths = chunk_rays(
                film, camera, cfg, key, row0=0, rows=rows_per_chunk
            )
            k_lamp, _, k_splat = jax.random.split(jax.random.fold_in(key, 11), 3)
            path = trace_lamp_path(scene, lamp_cfg, k_lamp, wavelengths)
            conn = _connection_arrays(scene, path, wavelengths, cfg, k_splat)
            return conn, connectable_count(conn)

    def compact_step(conn, k_new):
        return _compact_connections(conn, k_new)

    def cam_step(acc, wt, key, data, conn, row0=0):
      """Phase 2: camera walk + connections + exposures against ``conn``
      (either full capacity or compacted)."""
      with scene.bind(data):
        positions, origin, direction, wavelengths = chunk_rays(
            film, camera, cfg, key, row0=row0, rows=rows_per_chunk
        )
        n = origin.shape[0]
        s_count = wavelengths.shape[1]
        slots = conn["conn_ok"].shape[1]
        pp, aux_ok = conn["pp"], conn["aux_ok"]
        len_lamp = conn["length"]
        k_cam = jax.random.split(jax.random.fold_in(key, 11), 3)[1]

        # --- camera walk with connections --------------------------------------
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
        extras = {
            "conn_vsum": jnp.zeros((n, s_count)),
            "conn_cnt": jnp.zeros((n, s_count)),
            "len_cam": jnp.zeros(n, jnp.int32),
        }

        # connections (connect_paths): diffuse camera vertices only.
        # All L+1 lamp slots are connected in ONE flattened [N*(L+1)]
        # shadow batch per bounce (the reference's per-vertex loop,
        # bidirectional.rs:310-398, is free on a CPU megakernel but costs
        # (L+1) serial dispatch rounds on the wavefront machine).
        def conn_pre(info):
            return _conn_query(info, conn["position"], conn["normal"], conn["conn_ok"])

        def conn_post(extras, new_state, info, pack, blocked):
            vsum, cnt = _conn_fold(
                new_state, info, pack, blocked, pp, aux_ok,
                extras["conn_vsum"], extras["conn_cnt"],
            )
            return dict(extras, conn_vsum=vsum, conn_cnt=cnt)

        def scan_body(carry, bounce_key):
            state, extras = carry
            new_state, info = bounce_core(scene, cfg, wavelengths, state, bounce_key)

            if scene.num_lamps > 0:
                vsum, cnt = _connect_fold_grouped(
                    scene, cfg, info, new_state,
                    conn["position"], conn["normal"], conn["conn_ok"],
                    pp, aux_ok, extras["conn_vsum"], extras["conn_cnt"],
                )
                extras = dict(extras, conn_vsum=vsum, conn_cnt=cnt)

            new_extras = dict(
                extras,
                len_cam=extras["len_cam"] + info["recorded"].astype(jnp.int32),
            )
            return (new_state, new_extras), None

        keys = jax.random.split(k_cam, cfg.bounces)

        # whole-batch early exit (the reference's per-thread loop stops when
        # a path dies; a fixed scan would pay full masked depth at 256-bounce
        # budgets)
        def cam_cond(carry):
            i, state, extras = carry
            return (i < cfg.bounces) & jnp.any(state["alive"])

        def cam_body(carry):
            i, state, extras = carry
            (state, extras), _ = scan_body((state, extras), keys[i])
            return i + 1, state, extras

        if scene.use_clusters and merged_traversal_enabled():
            # deferred bounce: the connection batch, the bounce's NEE batch,
            # and the NEXT bounce's extension rays share ONE traversal
            # (three serial cluster walks -> one per bounce)
            def cam_body_deferred(carry):
                i, state, extras, hit = carry
                new_state, info, nee = bounce_core(
                    scene, cfg, wavelengths, state, keys[i],
                    hit=hit, defer_nee=True,
                )
                shadow_qs = []
                if scene.num_lamps > 0:
                    query, pack = conn_pre(info)
                    shadow_qs.append(query)
                if nee is not None:
                    shadow_qs.append(nee[0])
                ext = new_state["alive"] & (i + 1 < cfg.bounces)
                next_hit, ts = merged_queries(
                    scene, cfg, shadow_qs,
                    new_state["origin"], new_state["direction"], ext,
                )
                if nee is not None:
                    delta = trace_direct_post(nee[1], ts[-1], n, s_count)
                    new_state = dict(
                        new_state,
                        brightness=new_state["brightness"] + delta,
                    )
                if scene.num_lamps > 0:
                    blocked = _conn_blocked(ts[0], query, n, slots)
                    extras = conn_post(extras, new_state, info, pack, blocked)
                extras = dict(
                    extras,
                    len_cam=extras["len_cam"]
                    + info["recorded"].astype(jnp.int32),
                )
                return i + 1, new_state, extras, next_hit

            hit0 = intersect_scene(scene, origin, direction, cfg)

            def cam_cond_deferred(carry):
                i, state, extras, hit = carry
                return (i < cfg.bounces) & jnp.any(state["alive"])

            _, state, extras, _ = jax.lax.while_loop(
                cam_cond_deferred, cam_body_deferred,
                (jnp.int32(0), state, extras, hit0),
            )
        else:
            _, state, extras = jax.lax.while_loop(
                cam_cond, cam_body, (jnp.int32(0), state, extras)
            )

        # --- exposures ---------------------------------------------------------
        # camera-path samples, weight 1 (hero always, aux if never dispersed)
        cam_mask = jnp.concatenate(
            [
                jnp.ones((n, 1), bool),
                jnp.broadcast_to(state["aux_alive"][:, None], (n, s_count - 1)),
            ],
            axis=1,
        )
        acc, wt = film.expose(
            acc,
            wt,
            positions,
            wavelengths,
            state["brightness"],
            jnp.ones((n, s_count)),
            cam_mask,
        )

        # connection samples: sums of (value * W) with weight sums C * W
        total = jnp.maximum(extras["len_cam"] * len_lamp, 1)
        w_conn = 1.0 / total.astype(jnp.float32)
        acc, wt = expose_sums(
            film,
            acc,
            wt,
            positions,
            wavelengths,
            extras["conn_vsum"] * w_conn[:, None],
            extras["conn_cnt"] * w_conn[:, None],
            jnp.ones((n, s_count), bool),
        )

        # light-tracing splats
        acc, wt = _light_splats(
            scene, film, camera, cfg, conn, wavelengths, acc, wt
        )
        return acc, wt

    def chunk_step(acc, wt, key, data, row0=0):
        conn, _ = lamp_step(key, data)
        return cam_step(acc, wt, key, data, conn, row0=row0)

    if two_phase:
        return (
            jax.jit(lamp_step),
            jax.jit(compact_step, static_argnums=(1,)),
            jax.jit(cam_step, donate_argnums=(0, 1)),
        )
    return jax.jit(chunk_step, donate_argnums=(0, 1)) if jit else chunk_step


# =============================================================================
# Camera-side path regeneration (deep camera budgets)
# =============================================================================
#
# Snowflake-class scenes run 256 camera bounces but the mean camera path is
# ~2 bounces long (measured survival at 4k lanes: 28%/27%/10%/8%... dead by
# ~64), so the one-shot camera walk's whole-batch early exit still executes
# ~30x more masked lane-bounces than useful ones. The camera walk adopts the
# simple renderer's path-regeneration scheduler (simple.make_regen_step):
# lanes own fixed pixels; a finished sample is exposed into per-lane bin
# accumulators and the lane immediately restarts a fresh camera sample.
#
# BDPT couples every sample's wavelengths to its lamp path (dispersion makes
# the lamp path's geometry and prefix products hero-wavelength-dependent),
# so a regenerated sample cannot simply redraw wavelengths against a fixed
# lamp path. Each launch therefore pre-traces one (wavelengths, lamp path)
# ROUND per sample — R rounds = the launch's sample count, traced
# sequentially on the host at one-shot capacity, compacted, and pad-stacked
# into [n, R, K'] trees; sample k of a lane uses round k, gathered into the
# loop carry when the lane regenerates. Every sample therefore pairs with
# its own fresh lamp path and wavelengths, exactly like the one-shot walk
# (no light-path reuse; an earlier reuse variant measured a ~2% low film
# ratio-estimator bias from the value/weight correlation it introduced).
# The R wavelength draws are sub-stratified across rounds (round r jitters
# within [r/R, (r+1)/R) of each spectral stratum) — same marginal
# distribution as the one-shot path's iid draws, strictly lower variance.
# Each round's light-tracing splats are exposed right after its lamp trace
# (they are independent of the camera walk), so splat fields never ride the
# stacked trees.

REGEN_BDPT_MIN_BOUNCES = 16  # below this the one-shot walk is fine


def regen_bdpt_min_bounces() -> int:
    """Camera-budget threshold for the regen scheduler; env-overridable so
    shallow budgets (cornell's 4, colors' 8) can be measured without a
    code change (PYRITE_TPU_REGEN_BDPT_MIN=1 forces regen on)."""
    import os

    return int(os.environ.get("PYRITE_TPU_REGEN_BDPT_MIN", REGEN_BDPT_MIN_BOUNCES))
REGEN_BDPT_SPP_CHUNK = 32  # samples (= lamp-path rounds) per launch


def _accumulate_lane_sums(film: Film, acc_l, wt_l, wavelengths, value_sums, weight_sums):
    """Per-lane (value, weight) accumulation into [N, bins] buffers — the
    expose_sums analogue of simple._accumulate_lane_bins."""
    from ..film import bin_lane_sums

    da, dw = bin_lane_sums(film, wavelengths, value_sums, weight_sums)
    return acc_l + da, wt_l + dw


# iteration cap per staged camera-walk launch on cluster scenes. The
# one-shot cam_step runs (R+1)*bounces regen iterations in ONE device
# launch, and on cluster scenes every iteration dispatches an extension
# cluster walk plus ~K'/G grouped connection shadow walks — at dragon scale
# (16k lanes, K'=257, 20 camera bounces, 3 stacked rounds) that is a
# multi-minute single launch. Staged launches
# run at most this many regen iterations each, carrying the loop state to
# the host between launches; the fold_in streams key on the global
# iteration counter, so staging is bitwise-identical to the one-shot walk.
_CAM_ITER_CAP = int(_os.environ.get("PYRITE_TPU_BDPT_CAM_CAP", "6"))

# connection chunks in the FIRST staged deferred-finish launch (each chunk
# is one cap-wide shadow walk): after it, launches pack as many chunks as
# the measured per-chunk wall fits into _CONN_LAUNCH_BUDGET seconds —
# adaptive pacing that bounds each launch while amortizing per-launch sync
# (not yet swept on the H100)
_CONN_LAUNCH_CHUNKS = int(_os.environ.get("PYRITE_TPU_CONN_LAUNCH_CHUNKS", "4"))
_CONN_LAUNCH_BUDGET = float(_os.environ.get("PYRITE_TPU_CONN_LAUNCH_BUDGET", "20"))

# host-side stage tracing for the staged BDPT driver (adds a
# block_until_ready after every stage, so only use it to attribute wall time)
_BDPT_TRACE = _os.environ.get("PYRITE_TPU_BDPT_TRACE", "0") == "1"


def _cam_zero_carry(n, slots, s, bins, wl0, defer_conn=False):
    """Zero loop state for the regen camera walk: every lane starts dead
    with done=0, so the first body iteration regenerates it from round 0.

    ``defer_conn``: the deferred body never reads the lane's connection
    tree (vertices are ring-buffered and folded against conn_r at the
    finish), so the carried ``cur`` keeps only wavelengths + lamp length —
    carrying the [n, K', ...] tree costs ~250 MB of where()-rewrite HBM
    traffic PER ITERATION at dragon scale, and the staged launches' host round-trip
    keeps XLA from dead-code-eliminating it."""
    state = {
        "origin": jnp.zeros((n, 3)),
        "direction": jnp.zeros((n, 3)).at[:, 2].set(1.0),
        "brightness": jnp.zeros((n, s)),
        "reflectance": jnp.ones((n, s)),
        "alive": jnp.zeros(n, bool),
        "aux_alive": jnp.ones(n, bool),
        "sample_light": jnp.ones(n, bool),
        "light_events": jnp.zeros(n, jnp.int32),
    }
    cur0 = {
        "wl": jnp.full((n, s), wl0),
        "len_lamp": jnp.ones(n, jnp.int32),
    }
    if not defer_conn:
        cur0.update({
            "position": jnp.zeros((n, slots, 3)),
            "normal": jnp.zeros((n, slots, 3)),
            "pp": jnp.zeros((n, slots, s)),
            "aux_ok": jnp.zeros((n, slots), bool),
            "conn_ok": jnp.zeros((n, slots), bool),
        })
    return {
        "i": jnp.int32(0),
        "state": state,
        "cur": cur0,
        "acc_l": jnp.zeros((n, bins)),
        "wt_l": jnp.zeros((n, bins)),
        "done": jnp.zeros(n, jnp.int32),
        "pend": jnp.zeros(n, bool),
        "plen": jnp.zeros(n, jnp.int32),
        "conn_vsum": jnp.zeros((n, s)),
        "conn_cnt": jnp.zeros((n, s)),
        "len_cam": jnp.zeros(n, jnp.int32),
        "live": jnp.float32(0.0),
    }


def make_regen_bdpt_steps(
    scene: Scene,
    film: Film,
    camera: CameraModel,
    cfg: TraceConfig,
    light_bounces: int,
    rows: int,
    rounds: int,
    jit: bool = True,
):
    """(lamp_step, compact_step, splat_step, stack_rounds, cam_step) of the
    camera-regeneration BDPT scheduler for launches of ``rounds`` samples:
    lamp_step draws one round's wavelengths + lamp paths, splat_step exposes
    that round's light-tracing splats, and cam_step completes ``spp_lane``
    (<= rounds) camera samples per lane — sample k against round k —
    regenerating dead lanes in place. Connection math is the one-shot
    walk's (bidirectional.rs:310-398, one flattened shadow batch per
    bounce)."""
    from .simple import _accumulate_lane_bins

    lamp_cfg = TraceConfig(
        bounces=light_bounces,
        light_samples=0,
        spectrum_samples=cfg.spectrum_samples,
        max_de_steps=cfg.max_de_steps,
    )
    w = film.width
    n = rows * w
    s = cfg.spectrum_samples
    r_count = rounds
    # deferred connections: cluster scenes only (dense scenes' in-loop fold
    # is one fused shadow batch; cluster walks inside the loop are both the
    # slow part and the crash-prone part). Correct only while each lane
    # runs at most one sample per round (spp_lane <= rounds — the driver
    # guarantees this), since sample k records into round-k ring slots.
    defer_conn = (
        bool(_CONN_DEFER)
        and scene.use_clusters
        and scene.num_lamps > 0
        and not _BDPT_NOCONN
        and not merged_traversal_enabled()  # the merged body folds in-line
    )
    v_cap = cfg.bounces  # recorded-vertex capacity per sample

    def _defer_buffers():
        return {
            "vbuf": {
                "pos": jnp.zeros((n, r_count, v_cap, 3)),
                "nor": jnp.zeros((n, r_count, v_cap, 3)),
                "refl": jnp.zeros((n, r_count, v_cap, s)),
                "bright": jnp.zeros((n, r_count, v_cap, s)),
                "brdf": jnp.ones((n, r_count, v_cap)),
                "aux": jnp.zeros((n, r_count, v_cap), bool),
                "valid": jnp.zeros((n, r_count, v_cap), bool),
            },
            "len_cam_r": jnp.zeros((n, r_count), jnp.int32),
        }

    def lamp_step(key, data, round_index):
        """One round's wavelength set + lamp paths + connection arrays at
        full [n, L+1] capacity (rounds run sequentially on the host so the
        full-capacity trace never exists more than once — deep light budgets
        like dragon's 256 would not fit R copies)."""
        with scene.bind(data):
            # stratified wavelengths, the round's draw sub-stratified to
            # slice r of each stratum; hero uniformly chosen (chunk_rays)
            u = jax.random.uniform(jax.random.fold_in(key, 13), (n, s + 1))
            u_strat = (round_index.astype(jnp.float32) + u[:, :s]) / r_count
            wavelengths = film.sample_wavelengths(u_strat)
            hero = jnp.minimum((u[:, s] * s).astype(jnp.int32), s - 1)
            cols = jnp.arange(s)[None, :]
            is_hero = cols == hero[:, None]
            hero_wl = jnp.sum(
                jnp.where(is_hero, wavelengths, 0.0), axis=1, keepdims=True
            )
            first_wl = wavelengths[:, :1]
            wavelengths = jnp.where(
                cols == 0, hero_wl, jnp.where(is_hero, first_wl, wavelengths)
            )  # [n, S]

            k_lamp, _, k_splat = jax.random.split(jax.random.fold_in(key, 11), 3)
            path = trace_lamp_path(scene, lamp_cfg, k_lamp, wavelengths)
            conn = _connection_arrays(scene, path, wavelengths, cfg, k_splat)
            return conn, wavelengths, connectable_count(conn)

    def lamp_step_all(key, data):
        """All R rounds' wavelengths + lamp paths in ONE n*R-lane launch —
        used when the full-capacity arrays fit the lane budget (shallow
        light budgets: no compaction needed, so the whole lamp phase is one
        launch instead of R). Flat layout is lane-major: index = lane*R + r,
        matching stack_rounds' [n, R, ...] reshape."""
        with scene.bind(data):
            u = jax.random.uniform(
                jax.random.fold_in(key, 13), (n, r_count, s + 1)
            )
            ridx = jnp.arange(r_count, dtype=jnp.float32)[None, :, None]
            u_strat = ((ridx + u[:, :, :s]) / r_count).reshape(n * r_count, s)
            wavelengths = film.sample_wavelengths(u_strat)
            hero = jnp.minimum(
                (u[:, :, s].reshape(-1) * s).astype(jnp.int32), s - 1
            )
            cols = jnp.arange(s)[None, :]
            is_hero = cols == hero[:, None]
            hero_wl = jnp.sum(
                jnp.where(is_hero, wavelengths, 0.0), axis=1, keepdims=True
            )
            first_wl = wavelengths[:, :1]
            wavelengths = jnp.where(
                cols == 0, hero_wl, jnp.where(is_hero, first_wl, wavelengths)
            )  # [n*R, S]

            k_lamp, _, k_splat = jax.random.split(jax.random.fold_in(key, 11), 3)
            path = trace_lamp_path(scene, lamp_cfg, k_lamp, wavelengths)
            conn = _connection_arrays(scene, path, wavelengths, cfg, k_splat)
            return conn, wavelengths

    def by_round(conn, wavelengths):
        """Reshape lamp_step_all's flat [n*R, ...] outputs into the [n, R,
        ...] trees cam_step consumes (splat fields dropped)."""
        shaped = {
            f: v.reshape((n, r_count) + v.shape[1:])
            for f, v in conn.items()
            if f not in ("splat_u", "splat_ok")
        }
        return shaped, wavelengths.reshape(n, r_count, s)

    def compact_step(conn, k_new):
        return _compact_connections(conn, k_new)

    def splat_step(acc, wt, conn, wavelengths, data, scale):
        """Expose one round's light-tracing splats (they depend only on the
        lamp side, so they run during the lamp phase). ``scale`` [n]: number
        of samples the round serves (1 — kept general for partial rounds)."""
        with scene.bind(data):
            return _light_splats(
                scene, film, camera, cfg, conn, wavelengths, acc, wt,
                scale_lanes=scale,
            )

    def stack_rounds(conns, wls):
        """Pad each compacted round to the widest slot count and stack into
        [n, R, K'] trees (+ wavelengths [n, R, S]). Padded slots are masked
        inert (conn_ok False); splat fields are dropped (already exposed)."""
        k_max = max(c["conn_ok"].shape[1] for c in conns)
        if k_max > (light_bounces + 1) * 3 // 4:
            # near-full stacks pad to full capacity so every deep flush
            # shares ONE compiled cam variant (256- vs 257-slot stacks would
            # otherwise each compile a multi-minute camera walk)
            k_max = light_bounces + 1

        def pad(x):
            if x.ndim < 2 or x.shape[1] == k_max:
                return x
            widths = [(0, 0)] * x.ndim
            widths[1] = (0, k_max - x.shape[1])
            return jnp.pad(x, widths)

        stacked = {}
        for f in conns[0]:
            if f in ("splat_u", "splat_ok"):
                continue
            if f == "length":
                stacked[f] = jnp.stack([c[f] for c in conns], axis=1)
            else:
                stacked[f] = jnp.stack([pad(c[f]) for c in conns], axis=1)
        return stacked, jnp.stack(wls, axis=1)

    def write_row_window(acc, wt, acc_l, wt_l, row0):
        """Add the [n, bins] lane accumulators into the film's row window."""
        flat_acc = acc.reshape(film.height * w, film.bins)
        flat_wt = wt.reshape(film.height * w, film.bins)
        start = row0 * w
        flat_acc = jax.lax.dynamic_update_slice_in_dim(
            flat_acc,
            jax.lax.dynamic_slice_in_dim(flat_acc, start, n) + acc_l,
            start, axis=0,
        )
        flat_wt = jax.lax.dynamic_update_slice_in_dim(
            flat_wt,
            jax.lax.dynamic_slice_in_dim(flat_wt, start, n) + wt_l,
            start, axis=0,
        )
        return flat_acc.reshape(acc.shape), flat_wt.reshape(wt.shape)

    def cam_step(
        acc, wt, key, data, conn_r, wl_r, row0, spp_lane,
        carry_in=None, mode="full",
    ):
      """``conn_r``: stacked [n, R, K'] connection trees (stack_rounds);
      ``wl_r``: [n, R, S] per-round wavelengths.

      ``mode`` (trace-time static): "full" runs the whole regen walk in one
      launch; "iter" resumes from ``carry_in`` for at most _CAM_ITER_CAP
      iterations and returns (carry, more) so the host can bound launch
      length (cluster scenes — see _CAM_ITER_CAP); "finish" drains
      ``carry_in`` into the film."""
      with scene.bind(data):
        slots = conn_r["conn_ok"].shape[2]
        k_gen = jax.random.fold_in(key, 7919)
        k_tr = jax.random.fold_in(key, 7)
        len_r = jnp.maximum(conn_r["length"], 1)  # [n, R]

        def round_take(tree_field, ridx):
            """Gather each lane's round-``ridx`` row of a [n, R, ...] tree."""
            idx = ridx
            while idx.ndim < tree_field.ndim:
                idx = idx[..., None]
            return jnp.take_along_axis(
                tree_field, jnp.broadcast_to(idx, tree_field.shape[:1] + (1,) + tree_field.shape[2:]), axis=1
            )[:, 0]

        def fresh_rays(it_key):
            u = jax.random.uniform(it_key, (n, 4))
            py, px = jnp.meshgrid(
                row0 + jnp.arange(rows), jnp.arange(w), indexing="ij"
            )
            pxf = px.reshape(-1) + u[:, 0]
            pyf = py.reshape(-1) + u[:, 1]
            positions = film.pixel_to_view(pxf, pyf)
            return camera.ray_towards(positions, u[:, 2], u[:, 3])

        carry = _cam_zero_carry(
            n, slots, s, film.bins, film.span[0], defer_conn=defer_conn
        )
        if defer_conn:
            carry.update(_defer_buffers())
        state, cur0 = carry["state"], carry["cur"]
        max_iters = (jnp.max(spp_lane) + 1) * cfg.bounces

        def expose_complete(c, st):
            """Fold completed samples into the lane accumulators: the
            camera-path sample (weight 1, aux masked by dispersal) plus the
            sample's connection sums at 1/(len_cam*len_lamp). Uses the
            lane's CURRENT round wavelengths (the round only advances at
            regeneration, after this exposure)."""
            complete = c["pend"] & ~st["alive"]
            acc_l, wt_l = _accumulate_lane_bins(
                film, c["acc_l"], c["wt_l"], c["cur"]["wl"], st["brightness"],
                st["aux_alive"], complete,
            )
            if not defer_conn:
                total = jnp.maximum(c["len_cam"] * c["cur"]["len_lamp"], 1)
                w_conn = jnp.where(
                    complete, 1.0 / total.astype(jnp.float32), 0.0
                )
                acc_l, wt_l = _accumulate_lane_sums(
                    film, acc_l, wt_l, c["cur"]["wl"],
                    c["conn_vsum"] * w_conn[:, None],
                    c["conn_cnt"] * w_conn[:, None],
                )
            return acc_l, wt_l, complete

        def cond(c):
            return jnp.any(c["state"]["alive"] | (c["done"] < spp_lane)) & (
                c["i"] < max_iters
            )

        def body(c):
            st = c["state"]
            lane_ix = jnp.arange(n, dtype=jnp.int32)
            # 1) expose paths that completed last bounce
            acc_l, wt_l, complete = expose_complete(c, st)
            if defer_conn:
                # the completing sample's recorded length, for the finish
                # step's 1/(len_cam*len_lamp) connection weights
                r_done = jnp.where(
                    complete, jnp.minimum(c["done"], r_count - 1), r_count
                )
                len_cam_r = c["len_cam_r"].at[lane_ix, r_done].set(
                    c["len_cam"], mode="drop"
                )
            done = c["done"] + complete.astype(jnp.int32)
            pend = c["pend"] & st["alive"]
            # 2) regenerate: fresh camera sample at the lane's pixel, with
            # the lane's next-round wavelengths + lamp-path connection row
            reg = ~st["alive"] & (done < spp_lane)
            ridx = (done % r_count)[:, None]  # [n, 1]
            cur = c["cur"]

            def swap(old, tree_field):
                new = round_take(tree_field, ridx)
                keep = reg
                while keep.ndim < old.ndim:
                    keep = keep[..., None]
                return jnp.where(keep, new, old)

            cur = {
                "wl": swap(cur["wl"], wl_r),
                "len_lamp": jnp.where(reg, round_take(len_r, ridx), cur["len_lamp"]),
            }
            if not defer_conn:
                # the in-loop fold reads the lane's round tree; the
                # deferred body folds against conn_r at the finish, so
                # carrying (and where()-rewriting) the [n, K', ...] tree
                # every iteration would only burn HBM (~250 MB/iter at
                # dragon scale)
                cur.update({
                    "position": swap(c["cur"]["position"], conn_r["position"]),
                    "normal": swap(c["cur"]["normal"], conn_r["normal"]),
                    "pp": swap(c["cur"]["pp"], conn_r["pp"]),
                    "aux_ok": swap(c["cur"]["aux_ok"], conn_r["aux_ok"]),
                    "conn_ok": swap(c["cur"]["conn_ok"], conn_r["conn_ok"]),
                })
            o2, d2 = fresh_rays(jax.random.fold_in(k_gen, c["i"]))
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
            pend = pend | reg
            plen = jnp.where(reg, 0, c["plen"])
            conn_vsum = jnp.where(rc, 0.0, c["conn_vsum"])
            conn_cnt = jnp.where(rc, 0.0, c["conn_cnt"])
            len_cam = jnp.where(reg, 0, c["len_cam"])
            live = c["live"] + jnp.sum(st["alive"].astype(jnp.float32))

            # 3) one bounce + connections for every live lane
            new_state, info = bounce_core(
                scene, cfg, cur["wl"], st, jax.random.fold_in(k_tr, c["i"])
            )
            out = {}
            if scene.num_lamps > 0 and not _BDPT_NOCONN:
                if defer_conn:
                    # record the diffuse vertex; the finish step batches all
                    # connection shadow walks top-level (_deferred_connections)
                    rec = info["is_diffuse"] & (len_cam < v_cap)
                    r_i = jnp.where(rec, ridx[:, 0], r_count)
                    v_i = jnp.minimum(len_cam, v_cap - 1)
                    ix = (lane_ix, r_i, v_i)
                    vb = c["vbuf"]
                    out["vbuf"] = {
                        "pos": vb["pos"].at[ix].set(info["position"], mode="drop"),
                        "nor": vb["nor"].at[ix].set(info["normal"], mode="drop"),
                        "refl": vb["refl"].at[ix].set(
                            new_state["reflectance"], mode="drop"
                        ),
                        "bright": vb["bright"].at[ix].set(
                            new_state["brightness"], mode="drop"
                        ),
                        "brdf": vb["brdf"].at[ix].set(
                            info["brdf_stored"], mode="drop"
                        ),
                        "aux": vb["aux"].at[ix].set(
                            new_state["aux_alive"], mode="drop"
                        ),
                        "valid": vb["valid"].at[ix].set(rec, mode="drop"),
                    }
                    out["len_cam_r"] = len_cam_r
                else:
                    # connect_paths (bidirectional.rs:310-398): one flattened
                    # [n*K] shadow batch per bounce (slot-grouped when K is
                    # large), identical math to the one-shot walk's scan_body
                    conn_vsum, conn_cnt = _connect_fold_grouped(
                        scene, cfg, info, new_state,
                        cur["position"], cur["normal"], cur["conn_ok"],
                        cur["pp"], cur["aux_ok"], conn_vsum, conn_cnt,
                    )

            len_cam = len_cam + info["recorded"].astype(jnp.int32)
            # per-path depth budget (the one-shot walk's iteration bound)
            plen = plen + new_state["alive"].astype(jnp.int32)
            new_state["alive"] = new_state["alive"] & (plen < cfg.bounces)
            return {
                "i": c["i"] + 1, "state": new_state, "cur": cur,
                "acc_l": acc_l, "wt_l": wt_l, "done": done, "pend": pend,
                "plen": plen, "conn_vsum": conn_vsum, "conn_cnt": conn_cnt,
                "len_cam": len_cam, "live": live, **out,
            }

        def body_deferred(c):
            """Deferred cluster bounce (tracer.merged_traversal_enabled):
            shade against the carried hit, regenerate dead lanes (round swap
            + fresh camera rays), then ONE merged traversal covers the
            connection batch, the NEE batch, and every next ray — one
            cluster walk per bounce instead of three serial ones. Exposure
            runs in-body after the verdicts land, so budget-killed lanes
            keep their final bounce's NEE + connection sums."""
            st = c["state"]
            cur = c["cur"]
            live = c["live"] + jnp.sum(st["alive"].astype(jnp.float32))
            new_state, info, nee = bounce_core(
                scene, cfg, cur["wl"], st, jax.random.fold_in(k_tr, c["i"]),
                hit=c["hit"], defer_nee=True,
            )
            if scene.num_lamps > 0:
                query, pack = _conn_query(
                    info, cur["position"], cur["normal"], cur["conn_ok"]
                )
            plen = c["plen"] + new_state["alive"].astype(jnp.int32)
            alive = new_state["alive"] & (plen < cfg.bounces)
            new_state = dict(new_state, alive=alive)
            complete = c["pend"] & ~alive
            done = c["done"] + complete.astype(jnp.int32)
            reg = ~alive & (done < spp_lane)

            ridx = (done % r_count)[:, None]

            def swap(old, tree_field):
                new = round_take(tree_field, ridx)
                keep = reg
                while keep.ndim < old.ndim:
                    keep = keep[..., None]
                return jnp.where(keep, new, old)

            cur_next = {
                "position": swap(cur["position"], conn_r["position"]),
                "normal": swap(cur["normal"], conn_r["normal"]),
                "pp": swap(cur["pp"], conn_r["pp"]),
                "aux_ok": swap(cur["aux_ok"], conn_r["aux_ok"]),
                "conn_ok": swap(cur["conn_ok"], conn_r["conn_ok"]),
                "wl": swap(cur["wl"], wl_r),
                "len_lamp": jnp.where(
                    reg, round_take(len_r, ridx), cur["len_lamp"]
                ),
            }
            o2, d2 = fresh_rays(jax.random.fold_in(k_gen, c["i"] + 1))
            rc = reg[:, None]
            next_o = jnp.where(rc, o2, new_state["origin"])
            next_d = jnp.where(rc, d2, new_state["direction"])

            shadow_qs = []
            if scene.num_lamps > 0:
                shadow_qs.append(query)
            if nee is not None:
                shadow_qs.append(nee[0])
            next_hit, ts = merged_queries(
                scene, cfg, shadow_qs, next_o, next_d, alive | reg
            )
            if nee is not None:
                delta = trace_direct_post(nee[1], ts[-1], n, s)
                new_state = dict(
                    new_state, brightness=new_state["brightness"] + delta
                )
            conn_vsum, conn_cnt = c["conn_vsum"], c["conn_cnt"]
            if scene.num_lamps > 0:
                blocked = _conn_blocked(ts[0], query, n, slots)
                conn_vsum, conn_cnt = _conn_fold(
                    new_state, info, pack, blocked, cur["pp"], cur["aux_ok"],
                    conn_vsum, conn_cnt,
                )
            len_cam = c["len_cam"] + info["recorded"].astype(jnp.int32)

            # exposure of completed samples: current-round wavelengths,
            # post-verdict brightness and connection sums
            tmp = dict(
                c, conn_vsum=conn_vsum, conn_cnt=conn_cnt, len_cam=len_cam
            )
            acc_l, wt_l, _ = expose_complete(tmp, new_state)

            state2 = {
                "origin": next_o,
                "direction": next_d,
                "brightness": jnp.where(rc, 0.0, new_state["brightness"]),
                "reflectance": jnp.where(rc, 1.0, new_state["reflectance"]),
                "alive": alive | reg,
                "aux_alive": jnp.where(reg, True, new_state["aux_alive"]),
                "sample_light": jnp.where(reg, True, new_state["sample_light"]),
                "light_events": jnp.where(reg, 0, new_state["light_events"]),
            }
            return {
                "i": c["i"] + 1, "state": state2, "cur": cur_next,
                "hit": next_hit, "acc_l": acc_l, "wt_l": wt_l, "done": done,
                "pend": (c["pend"] & alive) | reg,
                "plen": jnp.where(reg, 0, plen),
                "conn_vsum": jnp.where(rc, 0.0, conn_vsum),
                "conn_cnt": jnp.where(rc, 0.0, conn_cnt),
                "len_cam": jnp.where(reg, 0, len_cam),
                "live": live,
            }

        if mode == "iter":
            # staged launch: resume the plain (non-deferred) regen loop from
            # carry_in, bounded to _CAM_ITER_CAP iterations; identical
            # fold_in streams (they key on the global counter carry["i"])
            i0 = carry_in["i"]
            c = jax.lax.while_loop(
                lambda c: cond(c) & (c["i"] - i0 < _CAM_ITER_CAP),
                body,
                carry_in,
            )
            return c, cond(c)
        if mode == "finish":
            c = carry_in
        elif scene.use_clusters and merged_traversal_enabled():
            # pre-loop regeneration (round 0 + fresh rays) so the first
            # shade has a hit to consume
            has = spp_lane > 0
            ridx0 = jnp.zeros((n, 1), jnp.int32)

            def swap0(old, tree_field):
                new = round_take(tree_field, ridx0)
                keep = has
                while keep.ndim < old.ndim:
                    keep = keep[..., None]
                return jnp.where(keep, new, old)

            cur0d = {
                "position": swap0(cur0["position"], conn_r["position"]),
                "normal": swap0(cur0["normal"], conn_r["normal"]),
                "pp": swap0(cur0["pp"], conn_r["pp"]),
                "aux_ok": swap0(cur0["aux_ok"], conn_r["aux_ok"]),
                "conn_ok": swap0(cur0["conn_ok"], conn_r["conn_ok"]),
                "wl": swap0(cur0["wl"], wl_r),
                "len_lamp": jnp.where(
                    has, round_take(len_r, ridx0), cur0["len_lamp"]
                ),
            }
            o0, d0 = fresh_rays(jax.random.fold_in(k_gen, 0))
            hc = has[:, None]
            st0 = dict(
                state,
                origin=jnp.where(hc, o0, state["origin"]),
                direction=jnp.where(hc, d0, state["direction"]),
                alive=has,
            )
            carry = dict(
                carry, state=st0, cur=cur0d, pend=has,
                hit=intersect_scene(scene, st0["origin"], st0["direction"], cfg),
            )
            c = jax.lax.while_loop(cond, body_deferred, carry)
        else:
            c = jax.lax.while_loop(cond, body, carry)
        # drain: the final iteration's deaths were never exposed in-loop
        acc_l, wt_l, _ = expose_complete(c, c["state"])

        if defer_conn:
            # finish the deferred connections: final completions' len_cam,
            # then every recorded vertex's occlusion + fold in top-level
            # chunked batches, exposed per round at 1/(len_cam*len_lamp)
            lane_ix = jnp.arange(n, dtype=jnp.int32)
            complete_f = c["pend"] & ~c["state"]["alive"]
            r_done = jnp.where(
                complete_f, jnp.minimum(c["done"], r_count - 1), r_count
            )
            len_cam_r = c["len_cam_r"].at[lane_ix, r_done].set(
                c["len_cam"], mode="drop"
            )
            vsum_r, cnt_r = _deferred_connections(scene, cfg, conn_r, c["vbuf"])
            len_lamp_r = jnp.maximum(conn_r["length"], 1)  # [n, R]
            # len_cam_r == 0 <=> the sample never completed (quota or
            # max_iters cut it): inline never exposes those sums either
            w_r = jnp.where(
                len_cam_r > 0,
                1.0
                / jnp.maximum(len_cam_r * len_lamp_r, 1).astype(jnp.float32),
                0.0,
            )
            for k in range(r_count):
                acc_l, wt_l = _accumulate_lane_sums(
                    film, acc_l, wt_l, wl_r[:, k],
                    vsum_r[:, k] * w_r[:, k, None],
                    cnt_r[:, k] * w_r[:, k, None],
                )

        # write the lane accumulators into the film's row window
        acc, wt = write_row_window(acc, wt, acc_l, wt_l, row0)

        executed = c["i"].astype(jnp.float32) * n
        return acc, wt, c["live"], executed

    def cam_full(acc, wt, key, data, conn_r, wl_r, row0, spp_lane):
        """Array-only signature for jit (mode/carry_in stay trace-time
        Python values — a string kwarg would otherwise reach the tracer)."""
        return cam_step(acc, wt, key, data, conn_r, wl_r, row0, spp_lane)

    def cam_iter(key, data, conn_r, wl_r, row0, spp_lane, carry):
        """One staged camera-walk launch (<= _CAM_ITER_CAP regen iterations
        from ``carry``). Returns (carry', more)."""
        return cam_step(
            None, None, key, data, conn_r, wl_r, row0, spp_lane,
            carry_in=carry, mode="iter",
        )

    def cam_finish(acc, wt, key, data, conn_r, wl_r, row0, spp_lane, carry):
        """Drain a staged walk's final carry into the film."""
        return cam_step(
            acc, wt, key, data, conn_r, wl_r, row0, spp_lane,
            carry_in=carry, mode="finish",
        )

    # Staged deferred-connection finish: cam_finish's in-jit connection
    # fold is a DATA-DEPENDENT-length launch (one chunk walk per ~rows
    # recorded vertices; more than a minute at dragon scale). These three
    # steps let the host run it as bounded
    # launches: pack once, walk a few chunks per launch, expose once.
    def conn_pack_step(data, conn_r, carry):
        with scene.bind(data):
            c = carry
            st = c["state"]
            complete = c["pend"] & ~st["alive"]
            acc_l, wt_l = _accumulate_lane_bins(
                film, c["acc_l"], c["wt_l"], c["cur"]["wl"], st["brightness"],
                st["aux_alive"], complete,
            )
            lane_ix = jnp.arange(n, dtype=jnp.int32)
            r_done = jnp.where(
                complete, jnp.minimum(c["done"], r_count - 1), r_count
            )
            len_cam_r = c["len_cam_r"].at[lane_ix, r_done].set(
                c["len_cam"], mode="drop"
            )
            packed = _deferred_pack(
                c["vbuf"], _deferred_rows(scene, conn_r["conn_ok"].shape[2]),
                conn_r=conn_r if conn_ragged_enabled() else None,
            )
            head = {
                "acc_l": acc_l, "wt_l": wt_l, "len_cam_r": len_cam_r,
                "live": c["live"], "i": c["i"],
            }
            return packed, head

    def conn_chunks_step(data, conn_r, packed, i0, hi, vsum, cnt):
        """Walk chunks [i0, hi) of the packed connections; the host bounds
        each launch (hi - i0 chunks) against the watchdog."""
        with scene.bind(data):
            slots_c = conn_r["conn_ok"].shape[2]
            rows_c = _deferred_rows(scene, slots_c)

            if conn_ragged_enabled():
                def body(cr):
                    i, vsum, cnt = cr
                    vsum, cnt = _ragged_chunk(
                        scene, cfg, conn_r, packed, rows_c * slots_c,
                        i, vsum, cnt,
                    )
                    return i + 1, vsum, cnt
            else:
                def body(cr):
                    i, vsum, cnt = cr
                    vsum, cnt = _deferred_chunk(
                        scene, cfg, conn_r, packed, rows_c, i, vsum, cnt
                    )
                    return i + 1, vsum, cnt

            _, vsum, cnt = jax.lax.while_loop(
                lambda cr: cr[0] < hi, body, (i0, vsum, cnt)
            )
            return vsum, cnt

    def conn_expose_step(acc, wt, data, conn_r, wl_r, row0, head, vsum_r, cnt_r):
        with scene.bind(data):
            len_lamp_r = jnp.maximum(conn_r["length"], 1)  # [n, R]
            w_r = jnp.where(
                head["len_cam_r"] > 0,
                1.0
                / jnp.maximum(
                    head["len_cam_r"] * len_lamp_r, 1
                ).astype(jnp.float32),
                0.0,
            )
            acc_l, wt_l = head["acc_l"], head["wt_l"]
            for k in range(r_count):
                acc_l, wt_l = _accumulate_lane_sums(
                    film, acc_l, wt_l, wl_r[:, k],
                    vsum_r[:, k] * w_r[:, k, None],
                    cnt_r[:, k] * w_r[:, k, None],
                )
            acc, wt = write_row_window(acc, wt, acc_l, wt_l, row0)
            executed = head["i"].astype(jnp.float32) * n
            return acc, wt, head["live"], executed

    def carry0(slots):
        """Host-side zero carry for the staged walk (slots = conn_r K')."""
        c = _cam_zero_carry(
            n, slots, s, film.bins, film.span[0], defer_conn=defer_conn
        )
        if defer_conn:
            c.update(_defer_buffers())
        return c

    if not jit:
        return {
            "lamp": lamp_step,
            "lamp_all": lamp_step_all,
            "by_round": by_round,
            "compact": compact_step,
            "splat": splat_step,
            "stack": stack_rounds,
            "cam": cam_step,
            "cam_iter": cam_iter,
            "cam_finish": cam_finish,
            "conn_pack": conn_pack_step,
            "conn_chunks": conn_chunks_step,
            "conn_expose": conn_expose_step,
            "carry0": carry0,
            "defer_conn": defer_conn,
        }
    return {
        "lamp": jax.jit(lamp_step),
        "lamp_all": jax.jit(lamp_step_all),
        "by_round": by_round,  # host-side reshape of jitted outputs
        "compact": jax.jit(compact_step, static_argnums=(1,)),
        "splat": jax.jit(splat_step, donate_argnums=(0, 1)),
        "stack": stack_rounds,  # host-side pad + stack of jitted outputs
        "cam": jax.jit(cam_full, donate_argnums=(0, 1)),
        "cam_iter": jax.jit(cam_iter, donate_argnums=(6,)),
        "cam_finish": jax.jit(cam_finish, donate_argnums=(0, 1)),
        "conn_pack": jax.jit(conn_pack_step, donate_argnums=(2,)),
        "conn_chunks": jax.jit(conn_chunks_step, donate_argnums=(5, 6)),
        "conn_expose": jax.jit(conn_expose_step, donate_argnums=(0, 1)),
        "carry0": carry0,
        "defer_conn": defer_conn,
    }


def _render_regen_bdpt(
    scene, film, camera, cfg, light_bounces, rows, acc, wt, data, seed,
    start_sample, total, on_progress,
):
    """Host driver: per launch of ``take`` samples, ``take`` sequential lamp
    traces (each compacted to its connectable slot count, splats exposed
    immediately, then pad-stacked) + one camera-regeneration walk; chunks
    run center-out. Step sets are cached per launch size (the final partial
    launch compiles a second set)."""
    chunks = film.height // rows
    pix = rows * film.width
    slots = light_bounces + 1
    compacting = slots > 16
    # staged camera walks (bounded launches) on cluster scenes only: dense
    # scenes' regen iterations cost ~ms each, so the per-launch host sync
    # would dominate; the deferred (merged-traversal) body is not staged
    staged = (
        _CAM_ITER_CAP > 0
        and scene.use_clusters
        and not merged_traversal_enabled()
    )
    base_key = jax.random.PRNGKey(seed)
    order = chunk_order(chunks)
    ones = jnp.ones(pix, jnp.float32)
    steps_for = {}

    def run_cam(st, acc, wt, k_f, conn_r, wl_r, row0, spp_arr):
        """One chunk's camera walk: staged (bounded launches with host-side
        carry) on cluster scenes, one launch otherwise. With deferred
        connections the finish is ALSO staged (pack once, a few connection
        chunks per launch, expose once) — the in-jit finish's launch length
        is data-dependent and long at dragon scale."""
        import time as _t

        t_c = _t.time()
        if staged:
            carry = st["carry0"](conn_r["conn_ok"].shape[2])
            launches = 0
            while True:
                carry, more = st["cam_iter"](
                    k_f, data, conn_r, wl_r, row0, spp_arr, carry
                )
                launches += 1
                if not bool(more):
                    break
            if _BDPT_TRACE:
                print(
                    f"[bdpt] cam_iters x{launches} {_t.time()-t_c:.1f}s",
                    flush=True,
                )
                t_c = _t.time()
            if st["defer_conn"]:
                packed, head = st["conn_pack"](data, conn_r, carry)
                slots_c = conn_r["conn_ok"].shape[2]
                rows_c = _deferred_rows(scene, slots_c)
                if conn_ragged_enabled():
                    # ragged pair layout: chunk count follows the REAL
                    # connection count (mean lamp length), not count * K'
                    q_width = rows_c * slots_c
                    total_p = int(packed["pair_total"])
                    active = (total_p + q_width - 1) // q_width
                else:
                    count = int(packed["count"])
                    active = (count + rows_c - 1) // rows_c
                r_cnt = wl_r.shape[1]
                s_cnt = wl_r.shape[2]
                vsum = jnp.zeros((pix, r_cnt, s_cnt))
                cnt = jnp.zeros((pix, r_cnt, s_cnt))
                # adaptive pacing: measure chunk wall (each is one cap-wide
                # shadow walk) and pack launches to the time budget instead
                # of a guessed fixed count — the fetch bounds each launch
                per_chunk = None
                i0 = 0
                while i0 < active:
                    if per_chunk is None:
                        take_c = _CONN_LAUNCH_CHUNKS
                    else:
                        take_c = max(
                            1, min(64, int(_CONN_LAUNCH_BUDGET / per_chunk))
                        )
                    hi = min(i0 + take_c, active)
                    t_l = _t.time()
                    vsum, cnt = st["conn_chunks"](
                        data, conn_r, packed, jnp.int32(i0),
                        jnp.int32(hi), vsum, cnt,
                    )
                    jax.block_until_ready(vsum)  # bound the launch; free as we go
                    dt = (_t.time() - t_l) / (hi - i0)
                    per_chunk = dt if per_chunk is None else (
                        0.5 * per_chunk + 0.5 * dt
                    )
                    i0 = hi
                if _BDPT_TRACE:
                    print(
                        f"[bdpt] conn pack+{active}ch {_t.time()-t_c:.1f}s",
                        flush=True,
                    )
                    t_c = _t.time()
                acc, wt, _, _ = st["conn_expose"](
                    acc, wt, data, conn_r, wl_r, row0, head, vsum, cnt
                )
            else:
                acc, wt, _, _ = st["cam_finish"](
                    acc, wt, k_f, data, conn_r, wl_r, row0, spp_arr, carry
                )
        else:
            acc, wt, _, _ = st["cam"](
                acc, wt, k_f, data, conn_r, wl_r, row0, spp_arr
            )
        # wait for the walk's film before returning: the next chunk's lamp
        # otherwise dispatches while this walk's stacked [n, R, K']
        # connection trees are still resident, and the two footprints
        # together exceed device memory at dragon scale
        jax.block_until_ready((acc, wt))
        if _BDPT_TRACE:
            print(f"[bdpt] expose+sync {_t.time()-t_c:.1f}s", flush=True)
        return acc, wt

    done = start_sample
    while done < total:
        take = min(REGEN_BDPT_SPP_CHUNK, total - done)
        if take not in steps_for:
            steps_for[take] = make_regen_bdpt_steps(
                scene, film, camera, cfg, light_bounces, rows, rounds=take
            )
        st = steps_for[take]
        # shallow light budgets: one n*R-lane lamp launch + one splat per
        # chunk; deep budgets trace rounds sequentially (full-capacity
        # arrays would not fit R copies) and compact each round
        batched = not compacting and pix * take * slots * cfg.spectrum_samples <= _LANE_BUDGET
        spp_lane = jnp.full(pix, take, jnp.int32)
        for ci in order:
            key = jax.random.fold_in(jax.random.fold_in(base_key, ci), done)
            if batched:
                conn, wl = st["lamp_all"](key, data)
                acc, wt = st["splat"](
                    acc, wt, conn, wl, data, jnp.ones(pix * take, jnp.float32)
                )
                conn_r, wl_r = st["by_round"](conn, wl)
            else:
                # stack rounds greedily under a device-memory budget: the
                # stacked connection trees are [n, R, K', ...] and a deep
                # lamp budget can realize K' = 256 (dragon: 32k pixels x
                # 32 rounds x 256 slots x 10 lambda = 10.7 GB -> compile
                # OOM). Each sub-stack runs its own camera walk; the film
                # accumulates additively, and every sample still pairs
                # with its own lamp round, so the estimator is unchanged.
                conns, wls, stacked = [], [], 0
                flushes = 0

                def flush_stack(acc, wt, flushes):
                    # staged on cluster scenes (run_cam): one unbounded cam
                    # launch at dragon scale runs minutes of grouped cluster
                    # shadow walks; the staged walk is bitwise-identical to
                    # the one-shot walk
                    conn_r, wl_r = st["stack"](conns, wls)
                    spp_part = jnp.full(pix, len(conns), jnp.int32)
                    k_f = jax.random.fold_in(key, 5 + flushes)
                    acc, wt = run_cam(
                        st, acc, wt, k_f, conn_r, wl_r, ci * rows, spp_part
                    )
                    conns.clear()
                    wls.clear()
                    return acc, wt, flushes + 1

                for r in range(take):
                    import time as _t
                    t_r = _t.time()
                    k_r = jax.random.fold_in(key, 1009 + r)
                    conn, wl, count = st["lamp"](k_r, data, jnp.int32(r))
                    if _BDPT_TRACE:
                        jax.block_until_ready(conn)
                        print(f"[bdpt] lamp[{r}] {_t.time()-t_r:.1f}s", flush=True)
                        t_r = _t.time()
                    if compacting:
                        # TWO buckets only (slots/2, slots): every distinct
                        # k_new compiles its own compact/splat/stack/cam
                        # variant, and data-dependent counts otherwise
                        # sprinkle fresh buckets (and compiles) over the
                        # whole render. The ragged splat + full-capacity cam
                        # stacking made intermediate buckets worthless.
                        k_new = slots if int(count) > slots // 2 else (
                            max(4, slots // 2)
                        )
                        conn = st["compact"](conn, k_new)
                    if _BDPT_TRACE:
                        jax.block_until_ready(conn)
                        print(f"[bdpt] compact[{r}] k={k_new} {_t.time()-t_r:.1f}s", flush=True)
                        t_r = _t.time()
                    acc, wt = st["splat"](acc, wt, conn, wl, data, ones)
                    if _BDPT_TRACE:
                        jax.block_until_ready(acc)
                        print(f"[bdpt] splat[{r}] {_t.time()-t_r:.1f}s", flush=True)
                    k_round = conn["conn_ok"].shape[1]
                    cost = pix * k_round * (8 + cfg.spectrum_samples) * 4
                    if conns and stacked + cost > _CONN_STACK_BUDGET:
                        acc, wt, flushes = flush_stack(acc, wt, flushes)
                        stacked = 0
                    conns.append(conn)
                    wls.append(wl)
                    stacked += cost
                if conns:
                    acc, wt, flushes = flush_stack(acc, wt, flushes)
            if batched:
                acc, wt = run_cam(
                    st, acc, wt, key, conn_r, wl_r, ci * rows, spp_lane
                )
        done += take
        if on_progress is not None:
            on_progress(RenderProgress(sample=done, total=total, acc=acc, wt=wt, film=film))
    return film, acc, wt


def pick_rows_per_chunk(
    film: Film, light_bounces: int, spectrum_samples: int, scene=None, bounces=8
) -> int:
    budget_lanes = max(
        film.width, _LANE_BUDGET // ((light_bounces + 1) * spectrum_samples)
    )
    if scene is not None and scene.use_clusters:
        from ..tracer import CLUSTER_LANE_CAP

        cap = CLUSTER_LANE_CAP
        if light_bounces + 1 > 16:
            # deep lamp budgets carry [n, K'] connection trees through the
            # camera walk and stack [n, R, K'] rounds; at K' = 256 a 32k
            # wavefront needs ~17 GB of device memory (dragon-class).
            # Half the wavefront keeps the walk inside memory.
            cap //= 2
        budget_lanes = min(budget_lanes, cap)
    elif scene is not None and scene.num_primitives > 128:
        budget = 3_000_000_000
        per_lane = max(scene.num_primitives, 1) * max(bounces, 1) * (
            2 + light_bounces
        )
        budget_lanes = min(budget_lanes, max(film.width, budget // per_lane))
    rows = max(1, min(film.height, budget_lanes // film.width))
    # use a divisor of height so all chunks share one compiled shape
    while film.height % rows != 0:
        rows -= 1
    return rows


def render(project_data, scene: Scene, seed: int = 0, on_progress=None, max_samples=None, resume=None):
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
    rows = pick_rows_per_chunk(
        film,
        settings.light_bounces,
        settings.spectrum_samples,
        scene=scene,
        bounces=settings.bounces,
    )
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

    # deep camera budgets: regenerate camera samples in place (snowflake
    # runs 256 camera bounces with ~2-bounce mean paths — the one-shot walk
    # executes ~30x masked work)
    if cfg.bounces >= regen_bdpt_min_bounces() and regen_enabled():
        return _render_regen_bdpt(
            scene, film, camera, cfg, settings.light_bounces, rows, acc, wt,
            data, seed, start_sample, total, on_progress,
        )

    # deep light budgets ride the two-phase compacted-connection path; at
    # small L the full-capacity fused step is already cheap (and avoids the
    # extra host sync per chunk)
    two_phase = settings.light_bounces + 1 > 16
    if two_phase:
        lamp_step, compact_step, cam_step = make_render_step(
            scene, film, camera, cfg, settings.light_bounces, rows,
            two_phase=True,
        )
    else:
        step = make_render_step(scene, film, camera, cfg, settings.light_bounces, rows)

    chunks = film.height // rows
    import numpy as np

    keys = np.asarray(jax.random.split(jax.random.PRNGKey(seed), total * chunks))
    order = chunk_order(chunks)
    slots = settings.light_bounces + 1
    for i in range(start_sample, total):
        for c in order:
            key_c = keys[i * chunks + c]
            if two_phase:
                conn, count = lamp_step(key_c, data)
                # bucket to powers of two so only a handful of cam_step
                # shapes ever compile
                k_new = 4
                while k_new < int(count) and k_new < slots:
                    k_new *= 2
                k_new = min(k_new, slots)
                conn = compact_step(conn, k_new)
                acc, wt = cam_step(acc, wt, key_c, data, conn, c * rows)
            else:
                acc, wt = step(acc, wt, key_c, data, c * rows)
        if on_progress is not None:
            on_progress(RenderProgress(sample=i + 1, total=total, acc=acc, wt=wt, film=film))
    return film, acc, wt


def _render_regen_bdpt_sharded(
    scene, film, camera, cfg, light_bounces, rows, mesh, seed, total,
    on_progress=None, resume=None,
):
    """Camera-regeneration BDPT over the device mesh: each device runs the
    single-device scheduler on its own film shard (its own lamp rounds,
    wavelengths, and regen walk); a launch group advances up to
    D * REGEN_BDPT_SPP_CHUNK samples, the remainder split across devices
    via per-device sample targets and per-round splat scales. Film merge
    stays the single psum at development time (parallel/mesh.py)."""
    import numpy as np
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..parallel.mesh import device_film_buffers, merge_films

    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    data = scene.device_data()
    chunks = film.height // rows
    pix = rows * film.width
    slots = light_bounces + 1
    compacting = slots > 16
    sharding = NamedSharding(mesh, P(axis))

    start = 0
    resume_films = None
    if resume is not None:
        resume_films = (resume["acc"], resume["wt"])
        start = resume["samples_done"]
    acc, wt = device_film_buffers(film, mesh, resume=resume_films)

    def take0(tree):
        return jax.tree_util.tree_map(lambda x: x[0], tree)

    def rep1(tree):
        return jax.tree_util.tree_map(lambda x: x[None], tree)

    steps_for = {}

    def sharded_steps(rounds):
        """Per-launch-size sharded step set (cached)."""
        if rounds in steps_for:
            return steps_for[rounds]
        raw = make_regen_bdpt_steps(
            scene, film, camera, cfg, light_bounces, rows, rounds=rounds,
            jit=False,
        )
        lamp_raw, compact_raw, splat_raw, cam_raw = (
            raw["lamp"], raw["compact"], raw["splat"], raw["cam"],
        )

        def per_dev_lamp(keys, data, r):
            conn, wl, count = lamp_raw(keys[0], data, r)
            return rep1(conn), wl[None], count[None]

        lamp = jax.jit(
            shard_map(
                per_dev_lamp, mesh=mesh,
                in_specs=(P(axis), P(), P()), out_specs=(P(axis), P(axis), P(axis)),
                check_vma=False,
            )
        )

        compact_fns = {}

        def compact(conn, k_new):
            if k_new not in compact_fns:

                def per_dev_compact(conn):
                    return rep1(compact_raw(take0(conn), k_new))

                compact_fns[k_new] = jax.jit(
                    shard_map(
                        per_dev_compact, mesh=mesh,
                        in_specs=(P(axis),), out_specs=P(axis),
                        check_vma=False,
                    )
                )
            return compact_fns[k_new](conn)

        def per_dev_splat(acc, wt, conn, wl, data, scale):
            acc2, wt2 = splat_raw(acc[0], wt[0], take0(conn), wl[0], data, scale[0])
            return acc2[None], wt2[None]

        splat = jax.jit(
            shard_map(
                per_dev_splat, mesh=mesh,
                in_specs=(P(axis),) * 4 + (P(), P(axis)),
                out_specs=(P(axis), P(axis)),
                check_vma=False,
            ),
            donate_argnums=(0, 1),
        )

        def per_dev_cam(acc, wt, keys, data, conn_r, wl_r, row0, spp_lane):
            acc2, wt2, live, ex = cam_raw(
                acc[0], wt[0], keys[0], data, take0(conn_r), wl_r[0], row0,
                spp_lane[0],
            )
            return acc2[None], wt2[None]

        cam = jax.jit(
            shard_map(
                per_dev_cam, mesh=mesh,
                in_specs=(P(axis), P(axis), P(axis), P(), P(axis), P(axis), P(), P(axis)),
                out_specs=(P(axis), P(axis)),
                check_vma=False,
            ),
            donate_argnums=(0, 1),
        )
        steps_for[rounds] = (lamp, compact, splat, cam)
        return steps_for[rounds]

    def stack_axis2(conns, wls):
        """Pad each round's [D, n, K_r] trees to the widest K and stack into
        [D, n, R, K'] (+ wavelengths [D, n, R, S])."""
        k_max = max(c["conn_ok"].shape[2] for c in conns)

        def pad(x):
            if x.ndim < 3 or x.shape[2] == k_max:
                return x
            widths = [(0, 0)] * x.ndim
            widths[2] = (0, k_max - x.shape[2])
            return jnp.pad(x, widths)

        stacked = {}
        for f in conns[0]:
            if f in ("splat_u", "splat_ok"):
                continue
            if f == "length":
                stacked[f] = jnp.stack([c[f] for c in conns], axis=2)
            else:
                stacked[f] = jnp.stack([pad(c[f]) for c in conns], axis=2)
        return stacked, jnp.stack(wls, axis=2)

    base_key = jax.random.PRNGKey(seed)
    order = chunk_order(chunks)
    done = start
    while done < total:
        group_take = min(n_dev * REGEN_BDPT_SPP_CHUNK, total - done)
        dev_base, dev_rem = divmod(group_take, n_dev)
        take_d = np.array(
            [dev_base + (1 if d < dev_rem else 0) for d in range(n_dev)],
            np.int32,
        )
        rounds = int(take_d.max())
        lamp, compact, splat, cam = sharded_steps(rounds)
        spp_lane = jax.device_put(
            np.repeat(take_d[:, None], pix, axis=1), sharding
        )
        for ci in order:
            key_c = jax.random.fold_in(jax.random.fold_in(base_key, ci), done)
            conns, wls = [], []
            for r in range(rounds):
                keys = jax.random.split(jax.random.fold_in(key_c, 1009 + r), n_dev)
                conn, wl, counts = lamp(keys, data, jnp.int32(r))
                if compacting:
                    count = int(jnp.max(counts))
                    k_new = 4
                    while k_new < count and k_new < slots:
                        k_new *= 2
                    k_new = min(k_new, slots)
                    conn = compact(conn, k_new)
                # rounds beyond a device's sample target serve no samples:
                # their splats expose at scale 0
                scale = jax.device_put(
                    np.repeat(
                        (r < take_d).astype(np.float32)[:, None], pix, axis=1
                    ),
                    sharding,
                )
                acc, wt = splat(acc, wt, conn, wl, data, scale)
                conns.append(conn)
                wls.append(wl)
            conn_r, wl_r = stack_axis2(conns, wls)
            acc, wt = cam(
                acc, wt,
                jax.random.split(jax.random.fold_in(key_c, 7577), n_dev),
                data, conn_r, wl_r, jnp.int32(ci * rows), spp_lane,
            )
            # per-chunk sync, same reason as run_cam's: don't let the next
            # chunk's lamp launch while this walk's stacked trees are
            # resident (device memory at dragon scale)
            jax.block_until_ready((acc, wt))
        done += group_take
        if on_progress is not None:
            m_acc, m_wt = merge_films(acc, wt)
            on_progress(RenderProgress(sample=done, total=total, acc=m_acc, wt=m_wt, film=film))
    m_acc, m_wt = merge_films(acc, wt)
    return film, m_acc, m_wt


def render_sharded(project_data, scene: Scene, mesh, seed: int = 0, on_progress=None, max_samples=None, resume=None):
    """Multi-device BDPT: samples sharded over the mesh exactly like the
    simple renderer — the per-chunk step is already a pure film-delta
    function, so it lifts unchanged (reference runs all algorithms through
    one TaskRunner, renderer/mod.rs:77-111)."""
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
    rows = pick_rows_per_chunk(
        film,
        settings.light_bounces,
        settings.spectrum_samples,
        scene=scene,
        bounces=settings.bounces,
    )
    total = settings.pixel_samples if max_samples is None else min(
        settings.pixel_samples, max_samples
    )

    # deep camera budgets: per-device camera-regeneration walks (the
    # single-device scheduler lifted onto the mesh; every device renders its
    # own full set of samples per launch group, so D devices advance D
    # samples per host sample index exactly like run_sharded)
    if cfg.bounces >= regen_bdpt_min_bounces() and regen_enabled():
        return _render_regen_bdpt_sharded(
            scene, film, camera, cfg, settings.light_bounces, rows, mesh,
            seed, total, on_progress=on_progress, resume=resume,
        )

    step = make_render_step(
        scene, film, camera, cfg, settings.light_bounces, rows, jit=False
    )
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
