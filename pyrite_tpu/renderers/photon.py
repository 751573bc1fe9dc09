"""Progressive photon mapping (reference: renderer/photon_mapping.rs).

Per pixel pass the reference (1) traces camera paths, keeping chains of
diffuse hit vertices, (2) shoots photon batches from the lamps, keeping
diffuse light-bounce chains in a kd-tree, and (3) gathers photons within a
fixed radius around every camera vertex, multiplying the camera-side
reflectance chain by the photon-side light chain (photon_mapping.rs:340-426).

Wavefront formulation:
  - chain walks become prefix products computed during the traces: a camera
    vertex carries partialR(lambda) = product over its ancestor chain of
    color*probability*brdf times its own color*probability (its own brdf,
    2|n.exit|, is applied per gathered photon); a photon carries its full
    accumulated power P(lambda).
  - the kd-tree radius query becomes a hash-grid gather: photons are sorted
    by cell id (cell size = gather radius) and each camera vertex scans the
    27 neighboring cells with a per-cell photon cap.

Wavelength mechanism (photon_mapping.rs:352-399): every lamp path carries ONE
uniform random wavelength (photon_mapping.rs:199); each gathered (camera
vertex, photon) pair exposes a primary sample whose wavelength follows the
dispersal rules — photon's exact lambda normally, the camera hero lambda when
the camera vertex dispersed, pair skipped when both dispersed — plus
``spectrum_samples`` fresh uniform wavelengths when neither vertex dispersed.
Photon powers are exact at the photon's own lambda (traced in column 0).
Chain re-evaluation at other wavelengths (the reference re-walks both chains
per pair per sample) is EXACT for lambda-only scenes (every color program a
pure function of wavelength): vertices/photons record color-program count
vectors + scalar prefixes, and the gather re-walks chains in closed form
(exact_chain_mode below; verified against traced probe columns by
``tests/test_renderers.py::test_photon_exact_chain_reeval``). Scenes with
texture/fresnel-colored materials fall back to dense lambda-grid prefix
products linearly interpolated to the sample wavelength, bounded by the
interpolation-error test. Fresh wavelengths are drawn per (vertex, bounce)
and shared by that vertex's gathered pairs instead of per pair (same
estimator, slightly more correlation).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

from ..exprs import ProgramInputs
from ..film import Film
from ..scene import CameraModel, Scene
from ..tracer import TraceConfig, bounce_core, trace_lamp_path
from .simple import RenderProgress, chunk_rays

_CELL_CAP = 32  # max photons consumed per grid cell per query


# --- exact lambda-only chain re-evaluation -----------------------------------
#
# The reference re-walks both chains' programs at each gathered pair's
# wavelength (photon_mapping.rs:340-426, 447-494, 524-562). When every color
# program is a pure function of wavelength (statically known:
# exprs.CompiledProgram.uses_ray_inputs is False), a chain value at ANY
# wavelength factors as  scalar * prod_m f_m(lambda)^(count_m)  where
# count_m is how often color program m appears in the (unordered) chain and
# scalar collects the lambda-independent probability/brdf factors. Each
# vertex/photon records its count vector + scalar; gather time evaluates the
# product in log space from per-batch program evals — EXACT chain re-walks
# with O(M) work per pair instead of O(chain length) program re-runs.
# Texture/fresnel-colored scenes fall back to the dense-grid interpolation
# path (bounded by the interp-error test).


def exact_chain_mode(scene: Scene) -> bool:
    """True when every color program reads only the wavelength, enabling
    exact per-pair chain re-evaluation. PYRITE_TPU_PHOTON_EXACT=0 forces
    the grid-interpolation path (used by its error-bound test)."""
    if os.environ.get("PYRITE_TPU_PHOTON_EXACT", "1") == "0":
        return False
    return all(not p.uses_ray_inputs for p in scene.color_programs)


def _log_factors(scene: Scene, lam):
    """Exact eval of every color program at ``lam`` (any shape), as
    (log|f_m|, sign flags): two [*lam.shape, M] arrays."""
    shape = lam.shape
    flat = lam.reshape(-1)
    inputs = ProgramInputs(wavelength=flat)
    logs, negs = [], []
    for prog in scene.color_programs:
        val = jnp.broadcast_to(prog.fn(inputs), flat.shape)
        logs.append(jnp.log(jnp.maximum(jnp.abs(val), 1e-37)))
        negs.append((val < 0).astype(jnp.float32))
    m = len(logs)
    return (
        jnp.stack(logs, axis=-1).reshape(shape + (m,)),
        jnp.stack(negs, axis=-1).reshape(shape + (m,)),
    )


def _chain_eval(counts, scalar, logF, negF):
    """scalar * prod_m f_m^counts[m] in log space with sign tracking.
    counts/logF/negF broadcast over [..., M]; scalar over [...]."""
    mag = jnp.exp(jnp.sum(counts * logF, axis=-1))
    parity = jnp.sum(counts * negF, axis=-1)
    sign = 1.0 - 2.0 * jnp.mod(parity, 2.0)
    return scalar * mag * sign


def _lamp_chain_counts(scene: Scene, path, m_count):
    """Photon-side half of exact re-evaluation: parent-chain color-program
    count vectors [N, L+1, M] and scalar (probability*brdf) prefix products
    [N, L+1]. Slot t covers slots 0..t-1 — a photon's power excludes its
    own color and brdf (accumulate_light, photon_mapping.rs:524-562)."""
    from .bidirectional import _effective_brdf

    brdf = _effective_brdf(path)
    factor_s = jnp.where(path["valid"], path["probability"] * brdf, 1.0)
    ps = jnp.cumprod(factor_s, axis=1)
    ps_parent = jnp.concatenate([jnp.ones_like(ps[:, :1]), ps[:, :-1]], axis=1)
    onehot = (
        (path["color_prog"][:, :, None] == jnp.arange(m_count)[None, None, :])
        & path["valid"][:, :, None]
    ).astype(jnp.float32)
    counts = jnp.cumsum(onehot, axis=1)
    counts_parent = jnp.concatenate(
        [jnp.zeros_like(counts[:, :1]), counts[:, :-1]], axis=1
    )
    return counts_parent, ps_parent


def _record_camera_vertices(scene, cfg, key, origin, direction, wavelengths, chain_m=None):
    """Camera pass: normal film contribution plus recorded diffuse vertices
    with prefix reflectance products (CameraBounce chains,
    photon_mapping.rs:107-148).

    With ``chain_m`` (= number of color programs) each vertex additionally
    records its ancestor-chain color-program COUNT VECTOR [N, M] and the
    scalar (lambda-independent) chain prefix, so lambda-only chains can be
    re-walked EXACTLY at arbitrary pair wavelengths at gather time
    (photon_mapping.rs:340-426's per-pair chain re-evaluation)."""
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

    def scan_body(carry, bounce_key):
        state, chainR, counts, scalar = carry
        new_state, info = bounce_core(scene, cfg, wavelengths, state, bounce_key)
        # chain product up to and including this bounce's color*probability
        # but NOT its brdf (applied per gathered photon as 2|n.exit|)
        partialR = jnp.where(
            info["reflected"][:, None], chainR * info["color_prob"], chainR
        )
        new_chainR = jnp.where(
            info["reflected"][:, None],
            partialR * info["brdf_stored"][:, None],
            chainR,
        )
        vertex = {
            "valid": info["is_diffuse"],
            "position": info["position"],
            "normal": info["normal"],
            "incident": info["incident"],
            "partialR": partialR,
            "dispersed": info["dispersed"],
        }
        if chain_m is not None:
            # counts include this bounce's own color program (partialR
            # includes its own color*prob); the scalar mirrors partialR's
            # scalar part (path_prob up to and incl. b, brdf strictly
            # before b)
            onehot = (
                info["color_prog"][:, None] == jnp.arange(chain_m)[None, :]
            ) & info["reflected"][:, None]
            new_counts = counts + onehot.astype(jnp.float32)
            v_scalar = jnp.where(
                info["reflected"], scalar * info["path_prob"], scalar
            )
            new_scalar = jnp.where(
                info["reflected"], v_scalar * info["brdf_stored"], scalar
            )
            vertex["counts"] = new_counts
            vertex["scalar"] = v_scalar
        else:
            new_counts, new_scalar = counts, scalar
        return (new_state, new_chainR, new_counts, new_scalar), vertex

    keys = jax.random.split(key, cfg.bounces)

    # whole-batch early exit + preallocated [N, L, ...] vertex buffers
    # (a fixed scan would pay full masked depth after every path died)
    carry0 = (
        state, jnp.ones((n, s_count)),
        jnp.zeros((n, chain_m if chain_m is not None else 1)),
        jnp.ones(n),
    )
    probe = jax.eval_shape(lambda: scan_body(carry0, keys[0])[1])
    bufs = jax.tree_util.tree_map(
        lambda s: jnp.zeros((n, cfg.bounces) + s.shape[1:], s.dtype), probe
    )

    def cond(c):
        i, carry, bufs = c
        return (i < cfg.bounces) & jnp.any(carry[0]["alive"])

    def body(c):
        i, carry, bufs = c
        carry, vertex = scan_body(carry, keys[i])
        bufs = jax.tree_util.tree_map(
            lambda b, v: b.at[:, i].set(v), bufs, vertex
        )
        return i + 1, carry, bufs

    _, (state, _, _, _), recorded = jax.lax.while_loop(
        cond, body, (jnp.int32(0), carry0, bufs)
    )
    return state, recorded


def _hash_cells(positions, radius):
    cell = jnp.floor(positions / radius).astype(jnp.int32)
    # mix the three coordinates into one sortable key
    return (
        cell[..., 0] * 73856093 ^ cell[..., 1] * 19349663 ^ cell[..., 2] * 83492791
    ), cell


# the 27 neighbor-cell offsets scanned around each query point
_CELL_OFFSETS = jnp.asarray(
    [[dx, dy, dz] for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)],
    jnp.int32,
)


def grid_sort_photons(p_pos, p_valid, radius):
    """Photon-side half of the hash grid: sort photons by cell key. Computed
    once per photon batch (the photon map does not change across camera
    bounces). Returns (order [P], sorted_keys [P])."""
    key_of, _ = _hash_cells(p_pos, radius)
    key_of = jnp.where(p_valid, key_of, jnp.iinfo(jnp.int32).max)
    order = jnp.argsort(key_of)
    return order, key_of[order]


def grid_query(sorted_keys, q_pos, radius):
    """Query-side half: locate the 27 neighbor cells of each query point in
    the sorted photon keys. Returns (starts [N, 27], ckeys [N, 27])."""
    _, q_cell = _hash_cells(q_pos, radius)
    cells = q_cell[:, None, :] + _CELL_OFFSETS[None, :, :]
    ckeys = (
        cells[..., 0] * 73856093
        ^ cells[..., 1] * 19349663
        ^ cells[..., 2] * 83492791
    )
    n = q_pos.shape[0]
    starts = jnp.searchsorted(sorted_keys, ckeys.reshape(-1)).reshape(n, 27)
    return starts, ckeys


def grid_prepare(p_pos, p_valid, q_pos, radius):
    """Sort photons by cell key and locate the 27 neighbor cells of each
    query: returns (order [P], sorted_keys [P], starts [N, 27], ckeys [N, 27]).
    Replaces the reference's kd-tree radius query (spatial/kd_tree.rs:47-106)
    with a sorted hash grid (cell size = gather radius)."""
    order, sorted_keys = grid_sort_photons(p_pos, p_valid, radius)
    starts, ckeys = grid_query(sorted_keys, q_pos, radius)
    return order, sorted_keys, starts, ckeys


def grid_scan_slot(k, order, sorted_keys, starts, ckeys, p_valid, p_pos, q_pos, radius):
    """Candidate photon for scan step k (cell k // CAP, slot k % CAP):
    returns (pj [N] photon index, match [N] in-radius mask). Scanning all
    27 * _CELL_CAP steps enumerates every in-radius photon exactly once
    (provided no cell holds more than _CELL_CAP photons)."""
    p_count = p_pos.shape[0]
    c = k // _CELL_CAP
    slot = k % _CELL_CAP
    idx = jnp.clip(starts[:, c] + slot, 0, p_count - 1)
    pj = order[idx]
    match = (sorted_keys[idx] == ckeys[:, c]) & p_valid[pj]
    d2 = jnp.sum((p_pos[pj] - q_pos) ** 2, axis=-1)
    match &= d2 <= radius * radius
    return pj, match


def interp_cols(rows, span, lam):
    """Linearly interpolate ``rows`` [N, B] — sampled at the B bin centers of
    ``span`` — at wavelengths ``lam`` [N] or [N, K]. Clamps to the end bins."""
    b = rows.shape[1]
    lo, hi = span
    d = (hi - lo) / b
    squeeze = lam.ndim == 1
    if squeeze:
        lam = lam[:, None]
    t = jnp.clip((lam - lo) / d - 0.5, 0.0, b - 1.0)
    i0 = jnp.minimum(t.astype(jnp.int32), b - 2)
    f = t - i0
    v0 = jnp.take_along_axis(rows, i0, axis=1)
    v1 = jnp.take_along_axis(rows, i0 + 1, axis=1)
    out = v0 + (v1 - v0) * f
    return out[:, 0] if squeeze else out


def _gather(
    scene,
    film,
    cfg,
    radius,
    photon_probability,
    cam,
    cam_wavelengths,
    grid_span_bins,
    key,
    photons,
    acc,
    wt,
    positions_view,
    exact=False,
):
    """Radius gather around each camera vertex (photon_mapping.rs:340-426).

    Per gathered pair: a primary sample at the dispersal-selected wavelength
    (photon's exact lambda / camera hero lambda), plus ``spectrum_samples``
    fresh uniform wavelengths when neither chain dispersed
    (photon_mapping.rs:352-381). Pair contributions are accumulated into
    film-wavelength bins inside the scan loop (the film only keeps binned
    lambda, so binning inside the loop is exact).

    ``exact``: chain values at pair wavelengths come from exact count-vector
    re-evaluation (lambda-only scenes) instead of grid interpolation."""
    from ..film import expose_sums

    n, bounces = cam["valid"].shape[:2]
    s_cam = cfg.spectrum_samples  # camera stratified columns (0..s_cam)
    g0, g_bins = grid_span_bins  # camera partialR grid columns (g0..g0+g_bins)
    k_fresh = cfg.spectrum_samples  # fresh wavelengths per non-dispersed pair
    lo, hi = film.span

    p_pos = photons["position"]  # [P, 3]
    p_valid = photons["valid"]
    p_power = photons["power"]  # [P, 1 + B]: col 0 exact at lambda_p
    p_lambda = photons["wavelength"]  # [P]
    p_disp = photons["dispersed"]

    # photon-side sort hoisted out of the bounce loop (the photon map does
    # not change across camera bounces); only the query side is per-bounce
    order, sorted_keys = grid_sort_photons(p_pos, p_valid, radius)

    lam0 = cam_wavelengths[:, 0]
    bf = film.bins
    bin_centers = lo + (jnp.arange(bf) + 0.5) * (hi - lo) / bf

    if exact:
        # per-batch exact program evals (outside the slot loop): photon-side
        # factors at each photon's own lambda, camera-side factors at each
        # lane's hero lambda
        p_counts = photons["counts"]  # [P, M]
        p_scalar = photons["scalar"]  # [P]
        logF_p, negF_p = _log_factors(scene, p_lambda)  # [P, M]
        logF0, negF0 = _log_factors(scene, lam0)  # [N, M]

    for b in range(bounces):
        valid = cam["valid"][:, b]
        pos = cam["position"][:, b]
        normal = cam["normal"][:, b]
        incident = cam["incident"][:, b]
        partialR = cam["partialR"][:, b]  # [N, s_cam + G]
        r_hero = partialR[:, 0]
        r_grid = partialR[:, g0 : g0 + g_bins]
        cam_dispersed = cam["dispersed"][:, b]

        # fresh wavelengths for this bounce's pairs (film.sample_wavelength
        # is uniform over the span, film.rs:64-66)
        kb = jax.random.fold_in(key, b)
        lam_f = jax.random.uniform(kb, (n, k_fresh), minval=lo, maxval=hi)
        lam_dark = jax.random.uniform(
            jax.random.fold_in(kb, 1), (n, k_fresh + 1), minval=lo, maxval=hi
        )

        if exact:
            c_b = cam["counts"][:, b]  # [N, M]
            s_b = cam["scalar"][:, b]  # [N]
            logFf, negFf = _log_factors(scene, lam_f)  # [N, K, M]

        starts, ckeys = grid_query(sorted_keys, pos, radius)

        cos_cam = jnp.maximum(jnp.sum(incident * -normal, axis=-1), 0.0)

        def gather_body(k, carry):
            acc_bins, cnt_bins, num_neighbors, fresh_psum, fresh_cnt = carry
            pj, in_rad = grid_scan_slot(
                k, order, sorted_keys, starts, ckeys, p_valid, p_pos, pos, radius
            )
            in_rad &= valid
            # every in-radius photon counts toward num_neighbors — including
            # both-dispersed pairs, which are then skipped without exposing
            # (photon_mapping.rs:346,355)
            num_neighbors = num_neighbors + in_rad.astype(jnp.int32)
            phot_disp = p_disp[pj]
            pair = in_rad & ~(cam_dispersed & phot_disp)

            exit_dir = -photons["incident"][pj]  # [N, 3]
            w_geom = jnp.maximum(jnp.sum(exit_dir * normal, axis=-1), 0.0)
            w_geom = w_geom * cos_cam / jnp.pi
            first_brdf = 2.0 * jnp.abs(jnp.sum(normal * exit_dir, axis=-1))
            g = first_brdf * w_geom

            rows = p_power[pj]  # [N, 1 + B] (exact mode: [N, 1])
            lam_p = p_lambda[pj]
            # primary sample: photon's exact lambda, or the camera hero
            # lambda when the camera vertex dispersed
            lam_sel = jnp.where(cam_dispersed, lam0, lam_p)
            if exact:
                # exact chain re-walks at the pair wavelength: the camera
                # chain at the photon's lambda, the photon chain at the
                # camera hero lambda (dispersed pairs keep traced columns)
                r_at_p = _chain_eval(c_b, s_b, logF_p[pj], negF_p[pj])
                p_at_0 = _chain_eval(
                    p_counts[pj], p_scalar[pj], logF0, negF0
                )
                r_sel = jnp.where(cam_dispersed, r_hero, r_at_p)
                p_sel = jnp.where(cam_dispersed, p_at_0, rows[:, 0])
            else:
                r_sel = jnp.where(cam_dispersed, r_hero, interp_cols(r_grid, film.span, lam_p))
                p_sel = jnp.where(cam_dispersed, interp_cols(rows[:, 1:], film.span, lam0), rows[:, 0])
            c = jnp.where(pair, r_sel * p_sel * g, 0.0)

            j = film.wavelength_to_bin(lam_sel)  # [N]
            onehot = j[:, None] == jnp.arange(bf)[None, :]
            live = onehot & pair[:, None]
            acc_bins = acc_bins + jnp.where(live, c[:, None], 0.0)
            cnt_bins = cnt_bins + live.astype(jnp.float32)

            # additional fresh samples only when neither vertex dispersed
            # (photon_mapping.rs:357-381); the camera factor R(lam_f) is
            # per-lane and multiplies after the loop
            both_clear = pair & ~cam_dispersed & ~phot_disp
            if exact:
                p_f = _chain_eval(
                    p_counts[pj][:, None, :], p_scalar[pj][:, None],
                    logFf, negFf,
                )  # [N, K]
            else:
                p_f = interp_cols(rows[:, 1:], film.span, lam_f)  # [N, K]
            fresh_psum = fresh_psum + jnp.where(
                both_clear[:, None], p_f * g[:, None], 0.0
            )
            fresh_cnt = fresh_cnt + both_clear.astype(jnp.int32)
            return acc_bins, cnt_bins, num_neighbors, fresh_psum, fresh_cnt

        acc_bins, cnt_bins, num_neighbors, fresh_psum, fresh_cnt = jax.lax.fori_loop(
            0,
            27 * _CELL_CAP,
            gather_body,
            (
                jnp.zeros((n, bf)),
                jnp.zeros((n, bf)),
                jnp.zeros(n, jnp.int32),
                jnp.zeros((n, k_fresh)),
                jnp.zeros(n, jnp.int32),
            ),
        )

        # every exposed sample carries weight photon_probability/num_neighbors
        has = num_neighbors > 0
        w1 = photon_probability / jnp.maximum(num_neighbors, 1)

        # primary samples, already binned by selected wavelength
        acc, wt = expose_sums(
            film,
            acc,
            wt,
            positions_view,
            jnp.broadcast_to(bin_centers[None, :], (n, bf)),
            acc_bins * w1[:, None],
            cnt_bins * w1[:, None],
            (valid & has)[:, None] & (cnt_bins > 0),
        )

        # fresh samples: R_cam(lam_f) * sum over pairs of P(lam_f) * g
        if exact:
            r_f = _chain_eval(c_b[:, None, :], s_b[:, None], logFf, negFf)
        else:
            r_f = interp_cols(r_grid, film.span, lam_f)  # [N, K]
        acc, wt = expose_sums(
            film,
            acc,
            wt,
            positions_view,
            lam_f,
            r_f * fresh_psum * w1[:, None],
            jnp.broadcast_to((fresh_cnt * w1)[:, None], (n, k_fresh)),
            (valid & has & (fresh_cnt > 0))[:, None]
            & jnp.ones((n, k_fresh), bool),
        )

        # no neighbors: spectrum_samples + 1 zero-brightness samples at fresh
        # wavelengths, weight 1/(bounces * photon_passes) each
        # (photon_mapping.rs:403-414)
        dark_w = jnp.where(valid & ~has, 1.0 / photons["darkness_denom"], 0.0)
        acc, wt = expose_sums(
            film,
            acc,
            wt,
            positions_view,
            lam_dark,
            jnp.zeros((n, k_fresh + 1)),
            jnp.broadcast_to(dark_w[:, None], (n, k_fresh + 1)),
            (valid & ~has)[:, None] & jnp.ones((n, k_fresh + 1), bool),
        )
    return acc, wt


def _build_parts(project_data, scene: Scene):
    """Shared construction for the single-device and sharded drivers."""
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
    photon_cfg = TraceConfig(
        bounces=settings.photon_bounces,
        light_samples=0,
        spectrum_samples=settings.spectrum_samples,
    )
    radius = settings.radius
    photon_probability = 1.0 / (
        settings.bounces * settings.photon_bounces * settings.photon_passes
    )
    darkness_denom = float(settings.bounces * settings.photon_passes)

    lo, hi = settings.spectrum_span
    b_bins = settings.spectrum_bins
    bin_centers = jnp.asarray(
        [lo + (i + 0.5) * (hi - lo) / b_bins for i in range(b_bins)]
    )

    # Lambda-only scenes re-walk chains EXACTLY at pair wavelengths from
    # per-vertex count vectors (exact_chain_mode above); the dense-grid
    # interpolation below only serves texture/fresnel-colored scenes.
    exact = exact_chain_mode(scene)
    m_count = len(scene.color_programs)

    # camera partialR wavelength grid for interpolating R(lambda) at
    # arbitrary pair wavelengths: as fine as the film bin grid, halved until
    # the [N, bounces, S + G] record buffer stays within budget. At 64 grid
    # points over the default span the measured deviation from exact chain
    # re-evaluation is p95 < 1e-6, max ~0.5% on a wiggly measured-style
    # spectrum (tests/test_renderers.py interpolation-error test; each
    # density halving costs ~4x), so the budget is sized to keep 64 points
    # even at 1024x512 films (512k lanes x 8 bounces x 74 cols = 310M
    # floats = 1.2 GB f32 of record buffer on a 16 GB chip).
    n_lanes = project.image.width * project.image.height
    g_bins = 0 if exact else b_bins
    while (
        g_bins > 8
        and n_lanes * max(settings.bounces, 1) * (settings.spectrum_samples + g_bins)
        > 400_000_000
    ):
        g_bins //= 2
    grid_centers = jnp.asarray(
        [lo + (i + 0.5) * (hi - lo) / g_bins for i in range(g_bins)]
    )

    def photon_batch(key, count):
        """Shoot ``count`` photons. Each lamp path carries one uniform random
        wavelength (photon_mapping.rs:199) traced in column 0 — photon powers
        are EXACT at that wavelength. Non-exact scenes additionally trace the
        film bin grid in the remaining columns for fresh-wavelength
        interpolation; exact scenes record count vectors + scalars instead
        (and trace a single column)."""
        k_wl, k_path = jax.random.split(key)
        lam_p = jax.random.uniform(k_wl, (count, 1), minval=lo, maxval=hi)
        if exact:
            wl = lam_p
        else:
            wl = jnp.concatenate(
                [lam_p, jnp.broadcast_to(bin_centers[None, :], (count, b_bins))],
                axis=1,
            )
        path = trace_lamp_path(scene, photon_cfg, k_path, wl)
        n_slots = path["valid"].shape[1]

        # power prefix products, like BDPT's PP
        from .bidirectional import _lamp_path_factors

        pp, _, _, inc = _lamp_path_factors(scene, path, wl, photon_cfg)
        # a photon's power is its own probability times the PARENT chain's
        # product (accumulate_light, photon_mapping.rs:524-562: the photon's
        # own color and brdf are NOT included)
        pp_parent = jnp.concatenate(
            [jnp.ones_like(pp[:, :1]), pp[:, :-1]], axis=1
        )
        power = path["probability"][:, :, None] * pp_parent

        # photons are the diffuse vertices; emitter (slot 0) is not a photon
        def flat(x):
            return x.reshape((count * n_slots,) + x.shape[2:])

        out = {
            "position": flat(path["position"]),
            # stored incident after the reference's pairs() reversal
            "incident": flat(inc),
            "power": power.reshape(count * n_slots, wl.shape[1]),
            "wavelength": flat(
                jnp.broadcast_to(lam_p, (count, n_slots))
            ),
            "valid": flat(path["valid"] & path["is_diffuse"]),
            "dispersed": flat(path["dispersed"]),
            "darkness_denom": darkness_denom,
        }
        if exact:
            counts_parent, ps_parent = _lamp_chain_counts(scene, path, m_count)
            out["counts"] = flat(counts_parent)
            out["scalar"] = flat(path["probability"] * ps_parent)
        return out

    def camera_step(acc, wt, key, data):
      with scene.bind(data):
        positions, origin, direction, wavelengths = chunk_rays(film, camera, cfg, key)
        n = origin.shape[0]
        s = cfg.spectrum_samples
        # camera paths traced with the interpolation grid appended so
        # partialR(lambda) is recorded on a dense grid alongside the
        # stratified film columns; only the film columns are exposed.
        # Exact scenes skip the grid columns: counts + scalars re-walk
        # chains at any wavelength.
        wl_ext = wavelengths if exact else jnp.concatenate(
            [wavelengths, jnp.broadcast_to(grid_centers[None, :], (n, g_bins))],
            axis=1,
        )
        k_t = jax.random.fold_in(key, 3)
        state, recorded = _record_camera_vertices(
            scene, cfg, k_t, origin, direction, wl_ext,
            chain_m=m_count if exact else None,
        )
        mask = jnp.concatenate(
            [
                jnp.ones((n, 1), bool),
                jnp.broadcast_to(state["aux_alive"][:, None], (n, s - 1)),
            ],
            axis=1,
        )
        acc, wt = film.expose(
            acc, wt, positions, wavelengths, state["brightness"][:, :s],
            jnp.ones((n, s)), mask,
        )
        return acc, wt, recorded, positions, wl_ext

    def gather_step(acc, wt, key, recorded, positions, wavelengths, data):
        with scene.bind(data):
            k_phot, k_lam = jax.random.split(jax.random.fold_in(key, 11))
            photons = photon_batch(k_phot, settings.photons)
            return _gather(
                scene, film, cfg, radius, photon_probability, recorded,
                wavelengths, (cfg.spectrum_samples, g_bins), k_lam, photons,
                acc, wt, positions, exact=exact,
            )

    return film, settings, camera_step, gather_step


def make_sample_step(project_data, scene: Scene):
    """One full pixel pass (camera trace + all photon passes) as a pure
    film-delta step ``(acc, wt, key, data, row0) -> (acc, wt)`` — the unit
    the mesh shards over (row0 unused: photon passes sweep the whole film)."""
    film, settings, camera_step, gather_step = _build_parts(project_data, scene)

    def sample_step(acc, wt, key, data, row0=0):
        del row0
        k_cam = jax.random.fold_in(key, 0)
        acc, wt, recorded, positions, wavelengths = camera_step(acc, wt, k_cam, data)
        for p in range(settings.photon_passes):
            k_p = jax.random.fold_in(key, p + 1)
            acc, wt = gather_step(
                acc, wt, k_p, recorded, positions, wavelengths, data
            )
        return acc, wt

    return film, sample_step


def render(project_data, scene: Scene, seed: int = 0, on_progress=None, max_samples=None, resume=None):
    film, settings, camera_step, gather_step = _build_parts(project_data, scene)
    camera_step = jax.jit(camera_step)
    gather_step = jax.jit(gather_step)

    acc, wt = film.new_buffers()
    key = jax.random.PRNGKey(seed)
    total = settings.pixel_samples if max_samples is None else min(
        settings.pixel_samples, max_samples
    )
    start_sample = 0
    if resume is not None:
        acc = jnp.asarray(resume["acc"])
        wt = jnp.asarray(resume["wt"])
        start_sample = resume["samples_done"]
    data = scene.device_data()
    import numpy as np

    all_keys = np.asarray(
        jax.random.split(key, total * (1 + settings.photon_passes))
    )
    cursor = 0
    for i in range(total):
        if i < start_sample:
            cursor += 1 + settings.photon_passes
            continue
        k_i = all_keys[cursor]; cursor += 1
        acc, wt, recorded, positions, wavelengths = camera_step(acc, wt, k_i, data)
        for p in range(settings.photon_passes):
            k_p = all_keys[cursor]; cursor += 1
            acc, wt = gather_step(
                acc, wt, k_p, recorded, positions, wavelengths, data
            )
        if on_progress is not None:
            on_progress(
                RenderProgress(sample=i + 1, total=total, acc=acc, wt=wt, film=film)
            )
    return film, acc, wt


def render_sharded(project_data, scene: Scene, mesh, seed: int = 0, on_progress=None, max_samples=None, resume=None):
    """Multi-device photon mapping: each device runs complete pixel passes
    (camera trace + its own photon batches) — independent progressive
    estimators whose weighted film sums merge with one all-reduce."""
    from ..parallel.mesh import run_sharded

    film, step = make_sample_step(project_data, scene)
    settings = project_data.project.renderer
    total = settings.pixel_samples if max_samples is None else min(
        settings.pixel_samples, max_samples
    )
    return run_sharded(
        step,
        film,
        mesh,
        scene.device_data(),
        total,
        seed=seed,
        on_progress=on_progress,
        resume=resume,
        progress_cls=RenderProgress,
    )
