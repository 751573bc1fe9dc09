"""Image texture loading (reference: texture.rs from_path/convert_pixels).

Textures are linearized at load: sRGB decode unless the ``linear`` flag is
set. Color textures become [H, W, 4] float32 (linear RGBA); mono textures
become [H, W] float32 luma (BT.709 weights on linear RGB, like palette's
Srgb->LinLuma conversion).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..png import read_png


def _srgb_to_linear(x: np.ndarray) -> np.ndarray:
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


@dataclass
class TextureData:
    data: np.ndarray  # [H, W, 4] color or [H, W] mono, float32, linear


def load_texture(path: str, linear: bool, mono: bool) -> TextureData:
    if not os.path.exists(path):
        # Missing asset (e.g. stripped large blobs in the reference tree):
        # warn and substitute a neutral placeholder so the scene still runs.
        print(f"Warning: texture '{path}' not found; using a placeholder.")
        if mono:
            return TextureData(data=np.full((2, 2), 0.5, np.float32))
        # (0.5, 0.5, 1.0): mid-gray-blue that decodes to the neutral normal
        # (0, 0, 1) when the texture is used as a normal map
        data = np.full((2, 2, 4), 0.5, np.float32)
        data[:, :, 2:] = 1.0
        return TextureData(data=data)
    pixels = read_png(path)
    scale = 65535.0 if pixels.dtype == np.uint16 else 255.0
    arr = pixels.astype(np.float32) / scale

    channels = arr.shape[2]
    if channels == 1:  # grayscale
        rgb = np.repeat(arr, 3, axis=2)
        alpha = np.ones_like(arr[:, :, :1])
    elif channels == 2:  # gray + alpha
        rgb = np.repeat(arr[:, :, :1], 3, axis=2)
        alpha = arr[:, :, 1:2]
    elif channels == 3:
        rgb = arr
        alpha = np.ones_like(arr[:, :, :1])
    else:
        rgb = arr[:, :, :3]
        alpha = arr[:, :, 3:4]

    if not linear:
        rgb = _srgb_to_linear(rgb)

    if mono:
        luma = rgb @ np.array([0.2126, 0.7152, 0.0722], np.float32)
        return TextureData(data=luma.astype(np.float32))
    rgba = np.concatenate([rgb, alpha], axis=2).astype(np.float32)
    return TextureData(data=rgba)


class TextureLoader:
    """Dedup-by-path texture registry (reference: project/textures.rs)."""

    def __init__(self, project_dir: str):
        self.project_dir = project_dir
        self._color: dict[str, TextureData] = {}
        self._mono: dict[str, TextureData] = {}

    def load_color(self, rel_path: str, linear: bool) -> TextureData:
        path = os.path.realpath(os.path.join(self.project_dir, rel_path))
        if path not in self._color:
            self._color[path] = load_texture(path, linear, mono=False)
        return self._color[path]

    def load_mono(self, rel_path: str, linear: bool) -> TextureData:
        path = os.path.realpath(os.path.join(self.project_dir, rel_path))
        if path not in self._mono:
            self._mono[path] = load_texture(path, linear, mono=True)
        return self._mono[path]
