"""Spectral data types and colorimetry for the renderer.

Everything radiometric in this framework is carried per-wavelength (nm).
This module holds the host/device representations of sampled spectra, the
CIE 1931 observer response, the Burns sRGB->reflectance basis, and the
standard illuminants, plus the spectrum->tristimulus development math.

Reference parity:
  - uniform "array" spectra and piecewise-linear "curve" spectra follow
    /root/reference/pyrite/src/project/spectra.rs:30-58 and
    /root/reference/pyrite/src/math.rs:17-73 (curves are 0 outside their
    domain, arrays clamp to their endpoints).
  - baked colorimetric constants follow /root/reference/pyrite/build.rs
    (including the RGB basis span quirk max = min + len).
  - blackbody + fresnel follow /root/reference/pyrite/src/math.rs:167-182.
  - spectrum_to_tristimulus follows /root/reference/pyrite/src/main.rs:352-418
    (trapezoid integration, XYZ scale factor 3.444).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp

DEFAULT_SPECTRUM_SPAN = (380.0, 780.0)

_DATA_PATH = os.path.join(os.path.dirname(__file__), "data", "colorimetry.npz")


@lru_cache(maxsize=1)
def _data():
    return np.load(_DATA_PATH)


@dataclass(frozen=True)
class ArraySpectrum:
    """Uniform-grid sampled spectrum. Clamps to endpoints outside [min, max].

    ``values`` may be [N] (scalar spectrum) or [N, C] (e.g. the RGB basis).
    """

    min: float
    max: float
    values: np.ndarray  # host copy; jnp-converted lazily at trace time

    def sample(self, wavelength):
        """Evaluate at ``wavelength`` (any jnp/np array). Returns matching shape
        (plus trailing channel dim if values are multi-channel)."""
        values = jnp.asarray(self.values)
        n = self.values.shape[0]
        w = jnp.asarray(wavelength)
        normalized = (w - self.min) / (self.max - self.min)
        float_index = jnp.clip(normalized * (n - 1), 0.0, n - 1.0)
        lo = jnp.clip(jnp.floor(float_index).astype(jnp.int32), 0, n - 2)
        frac = float_index - lo.astype(float_index.dtype)

        if values.ndim == 1 and n <= 128 and w.ndim > 0 and w.size >= 4096:
            # tiny-table path: a masked-weight contraction instead of a bulk
            # gather from a small table (the trade-off is not yet measured
            # on the H100). The weight matrix has (1-frac) at lo and frac at
            # lo+1 per row.
            idx = jnp.arange(n, dtype=jnp.int32)
            lo_e = lo[..., None]
            frac_e = frac[..., None]
            weights = jnp.where(idx == lo_e, 1.0 - frac_e, 0.0) + jnp.where(
                idx == lo_e + 1, frac_e, 0.0
            )
            return jnp.einsum(
                "...n,n->...", weights, values, precision=jax.lax.Precision.HIGHEST
            )

        if values.ndim == 1:
            a = values[lo]
            b = values[lo + 1]
        else:
            a = values[lo, :]
            b = values[lo + 1, :]
            frac = frac[..., None]
        return a * (1.0 - frac) + b * frac

    def sample_np(self, wavelength):
        return np.asarray(self.sample(wavelength))


@dataclass(frozen=True)
class CurveSpectrum:
    """Piecewise-linear spectrum over arbitrary (x, y) points.

    Returns 0 strictly outside (x[0], x[-1]) — including *at* the endpoints,
    matching the reference's Interpolated::get.
    """

    xs: np.ndarray
    ys: np.ndarray

    def sample(self, wavelength):
        w = jnp.asarray(wavelength)
        xs = jnp.asarray(self.xs)
        ys = jnp.asarray(self.ys)
        inside = (w > xs[0]) & (w < xs[-1])

        if len(self.xs) <= 64 and w.ndim > 0 and w.size >= 4096:
            # per-segment masked lerp instead of searchsorted+gather: P-1
            # segments evaluated in parallel, exactly one contains each
            # wavelength
            x0, x1 = xs[:-1], xs[1:]
            y0, y1 = ys[:-1], ys[1:]
            we = w[..., None]
            t = (we - x0) / (x1 - x0)
            seg = y0 + t * (y1 - y0)
            hit = (we >= x0) & (we < x1)
            val = jnp.sum(jnp.where(hit, seg, 0.0), axis=-1)
            return jnp.where(inside, val, 0.0)

        return jnp.where(inside, jnp.interp(w, xs, ys), 0.0)

    def sample_np(self, wavelength):
        return np.asarray(self.sample(wavelength))


def make_array_spectrum(min_wl, max_wl, points) -> ArraySpectrum:
    return ArraySpectrum(float(min_wl), float(max_wl), np.asarray(points, np.float32))


def make_curve_spectrum(points) -> CurveSpectrum:
    pts = sorted((float(x), float(y)) for x, y in points)
    xs = np.array([p[0] for p in pts], np.float32)
    ys = np.array([p[1] for p in pts], np.float32)
    return CurveSpectrum(xs, ys)


# ---------------------------------------------------------------------------
# Baked colorimetric constants (loaded from binary data, not codegen).
# ---------------------------------------------------------------------------


@lru_cache(maxsize=1)
def rgb_basis() -> ArraySpectrum:
    """Burns sRGB->spectral reflectance basis, [N, 3] over [360, 360+N]."""
    d = _data()
    span = d["rgb_basis_span"]
    return ArraySpectrum(float(span[0]), float(span[1]), d["rgb_basis"])


@lru_cache(maxsize=1)
def xyz_response() -> ArraySpectrum:
    """CIE 1931 2-degree observer (x̄, ȳ, z̄) as one [N, 3] array spectrum."""
    d = _data()
    span = d["xyz_span"]
    return ArraySpectrum(float(span[0]), float(span[1]), d["xyz_bar"])


@lru_cache(maxsize=1)
def d65() -> ArraySpectrum:
    d = _data()
    span = d["d65_span"]
    return ArraySpectrum(float(span[0]), float(span[1]), d["d65"])


@lru_cache(maxsize=1)
def illuminant_a() -> ArraySpectrum:
    d = _data()
    span = d["illum_a_span"]
    return ArraySpectrum(float(span[0]), float(span[1]), d["illum_a"])


def builtin_spectrum(name: str):
    if name == "d65":
        return d65()
    if name == "a":
        return illuminant_a()
    raise ValueError(f"unknown builtin spectrum: {name}")


# ---------------------------------------------------------------------------
# Physics helpers.
# ---------------------------------------------------------------------------


def blackbody(wavelength_nm, temperature):
    """Planck's law (un-normalized, same constants as the reference)."""
    wl = jnp.asarray(wavelength_nm) * 1.0e-9
    power_term = 3.74183e-16 * wl ** -5.0
    return power_term / (jnp.exp(1.4388e-2 / (wl * temperature)) - 1.0)


def schlick(ref_index1, ref_index2, normal, incident):
    """Schlick Fresnel approximation, vectorized over leading dims.

    ``normal``/``incident`` are [..., 3].
    """
    cos_psi = -jnp.sum(normal * incident, axis=-1)
    r0 = (ref_index1 - ref_index2) / (ref_index1 + ref_index2)

    n = ref_index1 / ref_index2
    sin_t2 = n * n * (1.0 - cos_psi * cos_psi)
    tir = sin_t2 > 1.0
    cos_out = jnp.sqrt(jnp.maximum(1.0 - sin_t2, 0.0))
    cos_psi = jnp.where(ref_index1 > ref_index2, cos_out, cos_psi)

    inv_cos = 1.0 - cos_psi
    r = r0 * r0 + (1.0 - r0 * r0) * inv_cos ** 5
    return jnp.where((ref_index1 > ref_index2) & tir, 1.0, r)


def fresnel(ior, env_ior, normal, incident):
    """Orientation-aware Fresnel (reference math.rs:167-175)."""
    entering = jnp.sum(incident * normal, axis=-1) < 0.0
    r_enter = schlick(env_ior, ior, normal, incident)
    r_exit = schlick(ior, env_ior, -normal, incident)
    return jnp.where(entering, r_enter, r_exit)


# ---------------------------------------------------------------------------
# Spectrum development (binned film spectrum -> XYZ -> sRGB).
# ---------------------------------------------------------------------------


def sample_binned(bins, span, wavelength):
    """Sample a binned spectrum [..., B] the way the film does: nearest bin by
    floor, 0 outside [min, max]. ``wavelength`` is [T]. Returns [..., T]."""
    lo, hi = span
    bins = jnp.asarray(bins)
    w = jnp.asarray(wavelength)
    nbins = bins.shape[-1]
    normalized = (w - lo) / (hi - lo)
    idx = jnp.clip((normalized * nbins).astype(jnp.int32), 0, nbins - 1)
    vals = bins[..., idx]
    inside = (w >= lo) & (w <= hi)
    return jnp.where(inside, vals, 0.0)


def development_wavelengths(span, step_size):
    """The trapezoid sample points used by the reference development loop:
    wl_0 = min, then += step while the left edge is < max (the last right edge
    may overshoot max; the binned spectrum reads 0 there)."""
    lo, hi = span
    steps = int(np.ceil((hi - lo) / step_size - 1e-6))
    return np.asarray(lo + step_size * np.arange(steps + 1), np.float32), steps


def spectrum_to_xyz(bins, span, step_size, sample_fn=None):
    """Integrate binned spectra [..., B] against the CIE observer.

    Returns XYZ [..., 3], scaled by 3.444 like the reference (main.rs:368).
    ``sample_fn(values, wavelengths)`` can post-process sampled intensities
    (used for the image ``filter``/``white`` pipeline).
    """
    wl, steps = development_wavelengths(span, step_size)
    resp = xyz_response().sample(wl)  # [T, 3]
    s = sample_binned(bins, span, wl)  # [..., T]
    if sample_fn is not None:
        s = sample_fn(s, jnp.asarray(wl))
    trap = np.full(len(wl), 1.0, np.float32)
    trap[0] = 0.5
    trap[-1] = 0.5
    weights = jnp.asarray(trap * step_size)  # [T]
    sum_xyz = jnp.einsum("...t,tc,t->...c", s, resp, weights)
    total_weight = steps * step_size
    return sum_xyz * (3.444 / total_weight)


# sRGB (D65) matrix, as used by palette's Xyz->LinSrgb conversion.
XYZ_TO_LINEAR_SRGB = np.array(
    [
        [3.2404542, -1.5371385, -0.4985314],
        [-0.9692660, 1.8760108, 0.0415560],
        [0.0556434, -0.2040259, 1.0572252],
    ],
    np.float32,
)


def xyz_to_linear_srgb(xyz):
    return jnp.einsum("...c,rc->...r", xyz, jnp.asarray(XYZ_TO_LINEAR_SRGB))


def linear_to_srgb(linear):
    l = jnp.clip(linear, 0.0, 1.0)
    return jnp.where(l <= 0.0031308, l * 12.92, 1.055 * l ** (1.0 / 2.4) - 0.055)


def develop_to_srgb(bins, span, step_size, sample_fn=None):
    """Full development: binned spectra [..., B] -> sRGB-encoded floats [..., 3]."""
    xyz = spectrum_to_xyz(bins, span, step_size, sample_fn)
    return linear_to_srgb(xyz_to_linear_srgb(xyz))
