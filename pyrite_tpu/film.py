"""Film: spectral accumulation buffer + image development.

The reference film is a lock-free CAS grain array that *drops* samples under
contention (film.rs:145-162). Here the film is a pure accumulator pair
(acc, weight) of shape [H, W, BINS] updated with deterministic scatter-adds;
per-device shards are merged with a psum at development time.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax.numpy as jnp

from . import spectra as spectra_mod


@dataclass(frozen=True)
class Film:
    width: int
    height: int
    bins: int
    span: tuple

    # --- buffers -------------------------------------------------------------
    def new_buffers(self):
        shape = (self.height, self.width, self.bins)
        return jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32)

    # --- aspect-ratio view <-> pixel mapping (film.rs:203-252) ----------------
    @property
    def _size(self) -> float:
        return float(max(self.width, self.height))

    @property
    def _ratio(self) -> float:
        return min(self.width, self.height) / max(self.width, self.height)

    def view_to_pixel(self, positions):
        """[.., 2] view coords -> (px, py, valid)."""
        x = positions[..., 0]
        y = positions[..., 1]
        if self.width >= self.height:
            valid = jnp.abs(y) <= self._ratio
            fx = x + 1.0
            fy = y + self._ratio
        else:
            valid = jnp.abs(x) <= self._ratio
            fx = x + self._ratio
            fy = y + 1.0
        px = jnp.floor(self._size * fx * 0.5).astype(jnp.int32)
        py = jnp.floor(self._size * fy * 0.5).astype(jnp.int32)
        valid &= (px >= 0) & (px < self.width) & (py >= 0) & (py < self.height)
        return px, py, valid

    def pixel_to_view(self, px, py):
        """Pixel coords (+ fractional jitter) -> view coords [.., 2].

        Matches Camera::to_view_area (cameras.rs:57-68): view x in [-1, 1]
        along the longer image axis."""
        max_dim = self._size
        x = (px - self.width * 0.5) / (max_dim * 0.5)
        y = (py - self.height * 0.5) / (max_dim * 0.5)
        return jnp.stack([x, y], axis=-1)

    # --- wavelengths ----------------------------------------------------------
    def sample_wavelengths(self, u):
        """Stratified wavelengths from uniforms ``u`` [..., S]
        (film.rs:68-83)."""
        count = u.shape[-1]
        lo, hi = self.span
        step = (hi - lo) / count
        offsets = jnp.arange(count, dtype=jnp.float32) * step
        return lo + offsets + u * step

    def wavelength_to_bin(self, wavelength):
        lo, hi = self.span
        idx = ((wavelength - lo) * (self.bins / (hi - lo))).astype(jnp.int32)
        return jnp.clip(idx, 0, self.bins - 1)

    # --- exposure ----------------------------------------------------------------
    def expose(self, acc, wt, positions, wavelengths, brightness, weights, mask):
        """Accumulate a batch of spectral samples.

        positions: [N, 2] view coords; wavelengths/brightness/weights/mask:
        [N, S]. Returns updated (acc, wt)."""
        px, py, valid = self.view_to_pixel(positions)
        bins = self.wavelength_to_bin(wavelengths)  # [N, S]
        flat_pixel = (py * self.width + px)[:, None]  # [N, 1]
        index = flat_pixel * self.bins + bins  # [N, S]
        ok = mask & valid[:, None]
        # NB: negative indices WRAP in jnp scatters; use size (dropped) instead
        index = jnp.where(ok, index, self.height * self.width * self.bins)
        acc_flat = acc.reshape(-1)
        wt_flat = wt.reshape(-1)
        acc_flat = acc_flat.at[index.reshape(-1)].add(
            (brightness * weights).reshape(-1), mode="drop"
        )
        wt_flat = wt_flat.at[index.reshape(-1)].add(
            jnp.where(ok, weights, 0.0).reshape(-1), mode="drop"
        )
        return acc_flat.reshape(acc.shape), wt_flat.reshape(wt.shape)

    # --- development -----------------------------------------------------------
    def develop(self, acc, wt):
        """acc/weight per bin -> [H, W, BINS] mean spectra."""
        return jnp.where(wt > 0.0, acc / jnp.where(wt > 0.0, wt, 1.0), 0.0)

    def to_srgb(self, acc, wt, step_size=2.0, sample_fn=None):
        bins = self.develop(acc, wt)
        return spectra_mod.develop_to_srgb(bins, self.span, step_size, sample_fn)

    def to_image(self, acc, wt, step_size=2.0, sample_fn=None):
        """Returns an [H, W, 3] uint8 numpy image."""
        srgb = self.to_srgb(acc, wt, step_size, sample_fn)
        out = np.asarray(srgb)
        return np.clip(np.rint(out * 255.0), 0, 255).astype(np.uint8)


# Raw-sum exposure: callers that pre-aggregate many samples per lane (e.g.
# BDPT connections, which expose len_cam x len_lamp samples at one pixel)
# add already-weighted value sums and weight sums directly.
def expose_sums(film: Film, acc, wt, positions, wavelengths, value_sums, weight_sums, mask):
    px, py, valid = film.view_to_pixel(positions)
    bins = film.wavelength_to_bin(wavelengths)
    flat_pixel = (py * film.width + px)[:, None]
    index = flat_pixel * film.bins + bins
    ok = mask & valid[:, None]
    # negative indices wrap in jnp scatters; use size (dropped) instead
    index = jnp.where(ok, index, film.height * film.width * film.bins)
    acc_flat = acc.reshape(-1).at[index.reshape(-1)].add(
        jnp.where(ok, value_sums, 0.0).reshape(-1), mode="drop"
    )
    wt_flat = wt.reshape(-1).at[index.reshape(-1)].add(
        jnp.where(ok, weight_sums, 0.0).reshape(-1), mode="drop"
    )
    return acc_flat.reshape(acc.shape), wt_flat.reshape(wt.shape)


def bin_lane_sums(film: Film, wavelengths, v, w):
    """Per-lane wavelength->bin binning: ([N, bins] value sums, [N, bins]
    weight sums) from [N, S] per-wavelength values/weights.

    Deliberately a fused elementwise compare+select+reduce: an einsum
    ("ns,nsb->nb") here would lower to N tiny batched matrix products. The
    reduction over S is unrolled so every intermediate stays [N, bins]: the
    3D [N, S, bins] one-hot form invites XLA to materialize multi-GB
    temporaries at megabatch width."""
    bins = film.wavelength_to_bin(wavelengths)  # [N, S]
    iota = jnp.arange(film.bins, dtype=bins.dtype)[None, :]
    n, s = v.shape
    acc = jnp.zeros((n, film.bins), v.dtype)
    wt = jnp.zeros((n, film.bins), w.dtype)
    for j in range(s):
        hit = bins[:, j : j + 1] == iota  # [N, bins]; where not *: 0*inf=nan
        acc = acc + jnp.where(hit, v[:, j : j + 1], 0.0)
        wt = wt + jnp.where(hit, w[:, j : j + 1], 0.0)
    return acc, wt


def expose_lanes(film: Film, acc, wt, row0, wavelengths, brightness, weights, mask):
    """Scatter-free exposure for the common case where wavefront lanes map
    1:1 onto film pixels in row-major order starting at row ``row0`` (the
    renderers trace exactly one jittered sample per pixel per step).

    The only irregular axis left is wavelength -> bin; that becomes a dense
    one-hot select-and-reduce over the S samples: elementwise math instead
    of a scatter."""
    n, s = brightness.shape
    v = jnp.where(mask, brightness * weights, 0.0)
    w = jnp.where(mask, weights, 0.0)
    acc_delta, wt_delta = bin_lane_sums(film, wavelengths, v, w)

    flat_acc = acc.reshape(film.height * film.width, film.bins)
    flat_wt = wt.reshape(film.height * film.width, film.bins)
    start = row0 * film.width
    import jax.lax as lax

    acc_rows = lax.dynamic_slice_in_dim(flat_acc, start, n) + acc_delta
    wt_rows = lax.dynamic_slice_in_dim(flat_wt, start, n) + wt_delta
    flat_acc = lax.dynamic_update_slice_in_dim(flat_acc, acc_rows, start, axis=0)
    flat_wt = lax.dynamic_update_slice_in_dim(flat_wt, wt_rows, start, axis=0)
    return flat_acc.reshape(acc.shape), flat_wt.reshape(wt.shape)
