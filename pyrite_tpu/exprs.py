"""Expression compiler: scene IR expression DAGs -> traced JAX functions.

The reference compiles expressions to a register-machine tape interpreted per
sample with dependency-flag memoization (program/compiler.rs,
program/execution_context.rs). On an accelerator the right shape is different: each
expression becomes a jnp-traced function evaluated for a whole wavefront of
rays and all spectral samples at once — vectorization subsumes the reference's
memoization. Type promotion (number / vector / rgb) follows
compiler.rs:682-968 exactly, including the Burns RGB->spectrum sampling used
when an RGB value is consumed as a spectral intensity
(execution_context.rs:140-152) and the x*2-1 RGB->vector normal-map decode.

Wavelength dependence is decided statically per program (does the DAG read
the wavelength input?), which matches the reference's dynamic
``wavelength_used`` tracking because the tape is fixed per material.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import jax.numpy as jnp

from . import spectra as spectra_mod
from .project import ir

NUMBER = "number"
VECTOR = "vector"
RGB = "rgb"


@dataclass
class ProgramInputs:
    """Runtime inputs for a compiled program.

    ``wavelength``: [N, S] (ray mode, hero at column 0) or [T] (plain mode).
    ``normal`` / ``incident``: [N, 3]; ``uv``: [N, 2]; None in plain mode.
    """

    wavelength: jnp.ndarray
    normal: Optional[jnp.ndarray] = None
    incident: Optional[jnp.ndarray] = None
    uv: Optional[jnp.ndarray] = None

    @property
    def ray_mode(self) -> bool:
        return self.normal is not None or (
            hasattr(self.wavelength, "ndim") and self.wavelength.ndim == 2
        )


@dataclass
class CompiledProgram:
    fn: Callable[[ProgramInputs], jnp.ndarray]
    output_type: str  # NUMBER or VECTOR
    uses_wavelength: bool
    constant: Optional[float] = None  # set when the program is a plain constant
    # False when the DAG reads only the wavelength (no uv/normal/incident):
    # such programs are pure functions of lambda and can be baked into a
    # shared [P, G] bank table (scene.bake_bank_tables) so material-heavy
    # scenes evaluate the whole bank with one gather instead of O(P) loops
    uses_ray_inputs: bool = False
    # True when the DAG samples an image texture (large-table gathers; the
    # simple renderer caps its wavefront for such scenes)
    uses_texture: bool = False

    def __call__(self, inputs: ProgramInputs) -> jnp.ndarray:
        return self.fn(inputs)


class Resources:
    """Shared spectrum/texture lookups for program compilation.

    Texture data lives in ``store`` (key -> array). Inside a jitted render
    step the Scene temporarily swaps ``store`` for a dict of tracers so the
    image data travels as jit *arguments* instead of being baked into the
    compiled program as constants (which blows up compile payloads)."""

    def __init__(self, texture_loader=None):
        self.texture_loader = texture_loader
        self._spectrum_cache: dict[int, object] = {}
        self.store: dict[str, object] = {}

    def spectrum(self, spec: ir.SpectrumIR):
        cached = self._spectrum_cache.get(id(spec))
        if cached is not None:
            return cached
        if spec.format == "builtin":
            s = spectra_mod.builtin_spectrum(spec.builtin)
        elif spec.format == "array":
            s = spectra_mod.make_array_spectrum(spec.min, spec.max, spec.points)
        else:
            s = spectra_mod.make_curve_spectrum(spec.points)
        self._spectrum_cache[id(spec)] = s
        return s

    def color_texture(self, path: str, linear: bool):
        key = f"color:{path}:{bool(linear)}"
        if key not in self.store:
            self.store[key] = self.texture_loader.load_color(path, linear).data
        return self.store[key]

    def mono_texture(self, path: str, linear: bool):
        key = f"mono:{path}:{bool(linear)}"
        if key not in self.store:
            self.store[key] = self.texture_loader.load_mono(path, linear).data
        return self.store[key]

    def preload(self, expr):
        """Eagerly register every texture an expression references so the
        store's key set is fixed before the first jit trace."""
        from .project import ir as _ir

        if not isinstance(expr, _ir.ComplexExpression):
            return
        seen = set()
        stack = [expr]
        while stack:
            node = stack.pop()
            if not isinstance(node, _ir.ComplexExpression) or id(node) in seen:
                continue
            seen.add(id(node))
            if node.kind == "color_texture":
                self.color_texture(node.fields["path"], node.fields["linear"])
            elif node.kind == "mono_texture":
                self.mono_texture(node.fields["path"], node.fields["linear"])
            for value in node.fields.values():
                if isinstance(value, _ir.ComplexExpression):
                    stack.append(value)


# --- value plumbing -----------------------------------------------------------
#
# In ray mode every value is broadcast-compatible with:
#   numbers: [N, S]    (per-ray-only values are [N, 1]; constants are scalars)
#   vec/rgb: [N, S, 4] (per-ray-only values are [N, 1, 4]; constants are (4,))
# In plain (no-ray) mode numbers broadcast with [T] and vec/rgb with [T, 4].


class _Value:
    __slots__ = ("type", "data", "uses_wl")

    def __init__(self, type_, data, uses_wl):
        self.type = type_
        self.data = data
        self.uses_wl = uses_wl


def _per_ray_number(x, inputs):
    """Lift a per-ray [N] array into number-broadcast form."""
    if inputs.ray_mode:
        return x[:, None]
    return x


def _per_ray_channels(x, inputs):
    """Lift a per-ray [N, C] array into channel-broadcast form."""
    if inputs.ray_mode:
        return x[:, None, :]
    return x


def _splat_rgb(value: _Value):
    n = value.data
    if isinstance(n, (int, float)):
        return jnp.array([n, n, n, 1.0], jnp.float32)
    arr = jnp.asarray(n)
    alpha = jnp.ones_like(arr)
    return jnp.stack([arr, arr, arr, alpha], axis=-1)


def _splat_vector(value: _Value):
    n = value.data
    if isinstance(n, (int, float)):
        return jnp.full((4,), n, jnp.float32)
    arr = jnp.asarray(n)
    return jnp.stack([arr, arr, arr, arr], axis=-1)


def _rgb_to_vector(data):
    return data * 2.0 - 1.0


def _rgb_to_number(value: _Value, inputs: ProgramInputs):
    """Burns sampling: dot(rgb, RGB_basis(wavelength)), summed over channels."""
    basis = spectra_mod.rgb_basis().sample(inputs.wavelength)  # [..., 3]
    rgb = value.data[..., :3] if not isinstance(value.data, (int, float)) else value.data
    response = rgb * basis
    return jnp.sum(response, axis=-1)


def _to_number(value: _Value, inputs: ProgramInputs) -> _Value:
    if value.type == NUMBER:
        return value
    if value.type == RGB:
        return _Value(NUMBER, _rgb_to_number(value, inputs), True)
    raise ir.ProjectError("cannot use a vector as a number")


def _promote_pair(lhs: _Value, rhs: _Value, inputs: ProgramInputs):
    """Type promotion for binary/mix ops, mirroring convert_operands."""
    order = {NUMBER: 0, RGB: 1, VECTOR: 2}
    target = max(lhs.type, rhs.type, key=lambda t: order[t])

    def convert(v: _Value) -> _Value:
        if v.type == target:
            return v
        if target == RGB:  # number -> rgb splat (alpha = 1)
            return _Value(RGB, _splat_rgb(v), v.uses_wl)
        # target == VECTOR
        if v.type == NUMBER:
            return _Value(VECTOR, _splat_vector(v), v.uses_wl)
        return _Value(VECTOR, _rgb_to_vector(v.data), v.uses_wl)  # rgb decode

    return convert(lhs), convert(rhs), target


def _bicubic_1d(v1, v2, v3, v4, t):
    """The reference's cubic (texture.rs:324-334)."""
    a = (v4 - v3) - (v1 - v2)
    b = (v1 - v2) - a
    c = v3 - v1
    d = v2
    return d + (c + (b + a * t) * t) * t


def sample_texture_bicubic(data: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """Bicubic texture fetch with wrap-around, matching texture.rs:88-148.

    ``data``: [H, W] or [H, W, C]; ``uv``: [N, 2]. Returns [N] or [N, C].
    """
    height, width = data.shape[0], data.shape[1]
    x = uv[:, 0] * width - 0.5
    x_floor = jnp.floor(x)
    y = (1.0 - uv[:, 1]) * height - 0.5
    y_floor = jnp.floor(y)

    def wrap_indices(floor_idx, size):
        i2 = jnp.mod(floor_idx.astype(jnp.int32), size)
        i1 = jnp.where(i2 == 0, size - 1, i2 - 1)
        i3 = jnp.where(i2 == size - 1, 0, i2 + 1)
        i4 = jnp.where(i3 == size - 1, 0, i3 + 1)
        return (i1, i2, i3, i4)

    xs = wrap_indices(x_floor, width)
    ys = wrap_indices(y_floor, height)
    tx = (x - x_floor)[:, None] if data.ndim == 3 else (x - x_floor)
    ty = (y - y_floor)[:, None] if data.ndim == 3 else (y - y_floor)

    rows = []
    for yi in ys:
        taps = [data[yi, xi] for xi in xs]
        rows.append(_bicubic_1d(taps[0], taps[1], taps[2], taps[3], tx))
    return _bicubic_1d(rows[0], rows[1], rows[2], rows[3], ty)


# --- the compiler -----------------------------------------------------------


def compile_program(
    expr: ir.Expression, resources: Resources, output_type: str = NUMBER
) -> CompiledProgram:
    """Compile an expression DAG into a function of ProgramInputs."""

    if isinstance(expr, float):
        if output_type == NUMBER:
            return CompiledProgram(
                fn=lambda inputs, v=expr: jnp.float32(v),
                output_type=NUMBER,
                uses_wavelength=False,
                constant=expr,
            )
        return CompiledProgram(
            fn=lambda inputs, v=expr: jnp.full((4,), v, jnp.float32),
            output_type=VECTOR,
            uses_wavelength=False,
            constant=expr,
        )

    # Static passes: wavelength usage of the *output* value, and whether any
    # node reads the per-ray geometry inputs (textures read uv, fresnel reads
    # normal/incident) — lambda-only programs are bank-table bakeable.
    uses_wl = _expr_uses_wavelength(expr, output_type)
    uses_ray = expr_uses_ray_inputs(expr)
    uses_tex = expr_uses_texture(expr)
    resources.preload(expr)

    def fn(inputs: ProgramInputs):
        cache: dict[int, _Value] = {}
        value = _eval_expr(expr, inputs, resources, cache)
        if output_type == NUMBER:
            return _to_number(value, inputs).data
        # VECTOR output
        if value.type == VECTOR:
            return value.data
        if value.type == RGB:
            return _rgb_to_vector(value.data)
        return _splat_vector(value)

    return CompiledProgram(
        fn=fn, output_type=output_type, uses_wavelength=uses_wl,
        uses_ray_inputs=uses_ray, uses_texture=uses_tex,
    )


def expr_uses_ray_inputs(expr: ir.Expression) -> bool:
    """True when any DAG node reads uv (textures) or normal/incident
    (fresnel) — i.e. the program is NOT a pure function of wavelength."""
    if isinstance(expr, float):
        return False
    seen = set()
    stack = [expr]
    while stack:
        node = stack.pop()
        if not isinstance(node, ir.ComplexExpression) or id(node) in seen:
            continue
        seen.add(id(node))
        if node.kind in ("color_texture", "mono_texture", "fresnel"):
            return True
        for value in node.fields.values():
            if isinstance(value, ir.ComplexExpression):
                stack.append(value)
    return False


def expr_uses_texture(expr: ir.Expression) -> bool:
    """True when any DAG node samples an image texture."""
    if isinstance(expr, float):
        return False
    seen = set()
    stack = [expr]
    while stack:
        node = stack.pop()
        if not isinstance(node, ir.ComplexExpression) or id(node) in seen:
            continue
        seen.add(id(node))
        if node.kind in ("color_texture", "mono_texture"):
            return True
        for value in node.fields.values():
            if isinstance(value, ir.ComplexExpression):
                stack.append(value)
    return False


def _expr_uses_wavelength(expr: ir.Expression, output_type: str) -> bool:
    """Does evaluating ``expr`` (coerced to ``output_type``) read the wavelength?

    RGB values coerced to numbers sample the Burns basis at the wavelength, so
    an RGB-typed result counts as wavelength-dependent for number outputs
    (matching ProbabilityInput::wavelength_used semantics)."""
    t, uses = _static_type(expr)
    if output_type == NUMBER and t == RGB:
        return True
    return uses


def _static_type(expr: ir.Expression):
    if isinstance(expr, float):
        return NUMBER, False
    kind = expr.kind
    f = expr.fields
    if kind == "vector":
        uses = any(_number_uses(f[a]) for a in ("x", "y", "z", "w"))
        return VECTOR, uses
    if kind == "rgb":
        uses = any(_number_uses(f[c]) for c in ("red", "green", "blue"))
        return RGB, uses
    if kind in ("binary", "mix"):
        lt, lu = _static_type(f["lhs"])
        rt, ru = _static_type(f["rhs"])
        order = {NUMBER: 0, RGB: 1, VECTOR: 2}
        target = max(lt, rt, key=lambda t: order[t])
        uses = lu or ru
        # promotions to number-compatible channels never read lambda, but an
        # rgb operand promoted *past* rgb (to vector) doesn't either; the only
        # lambda-introducing coercion is rgb->number which happens at
        # consumption sites, handled by the callers below.
        if kind == "mix":
            uses = uses or _number_uses(f["amount"])
        return target, uses
    if kind == "clamp":
        return NUMBER, (
            _number_uses(f["value"]) or _number_uses(f["min"]) or _number_uses(f["max"])
        )
    if kind == "fresnel":
        return NUMBER, (_number_uses(f["ior"]) or _number_uses(f["env_ior"]))
    if kind == "blackbody":
        return NUMBER, True
    if kind == "spectrum":
        return NUMBER, True
    if kind == "color_texture":
        return RGB, False
    if kind == "mono_texture":
        return NUMBER, False
    raise ir.ProjectError(f"unknown expression kind {kind!r}")


def _number_uses(expr: ir.Expression) -> bool:
    """Wavelength usage of an expression consumed as a number."""
    t, uses = _static_type(expr)
    return uses or t == RGB


def _eval_expr(expr, inputs, resources, cache) -> _Value:
    if isinstance(expr, float):
        return _Value(NUMBER, expr, False)
    cached = cache.get(id(expr))
    if cached is not None:
        return cached
    value = _eval_complex(expr, inputs, resources, cache)
    cache[id(expr)] = value
    return value


def _eval_number(expr, inputs, resources, cache):
    return _to_number(_eval_expr(expr, inputs, resources, cache), inputs)


def _eval_complex(expr: ir.ComplexExpression, inputs, resources, cache) -> _Value:
    kind = expr.kind
    f = expr.fields
    if kind == "vector":
        comps = [_eval_number(f[a], inputs, resources, cache) for a in ("x", "y", "z", "w")]
        uses = any(c.uses_wl for c in comps)
        data = jnp.stack(
            [jnp.broadcast_to(jnp.asarray(c.data, jnp.float32), _common_shape(comps)) for c in comps],
            axis=-1,
        )
        return _Value(VECTOR, data, uses)
    if kind == "rgb":
        comps = [
            _eval_number(f[c], inputs, resources, cache) for c in ("red", "green", "blue")
        ]
        uses = any(c.uses_wl for c in comps)
        shape = _common_shape(comps)
        stacked = [jnp.broadcast_to(jnp.asarray(c.data, jnp.float32), shape) for c in comps]
        stacked.append(jnp.ones(shape, jnp.float32))
        return _Value(RGB, jnp.stack(stacked, axis=-1), uses)
    if kind == "binary":
        lhs = _eval_expr(f["lhs"], inputs, resources, cache)
        rhs = _eval_expr(f["rhs"], inputs, resources, cache)
        lhs, rhs, target = _promote_pair(lhs, rhs, inputs)
        op = f["operator"]
        a, b = lhs.data, rhs.data
        if op == "add":
            data = a + b
        elif op == "sub":
            data = a - b
        elif op == "mul":
            data = a * b
        else:
            data = a / b
        return _Value(target, data, lhs.uses_wl or rhs.uses_wl)
    if kind == "mix":
        amount = _eval_number(f["amount"], inputs, resources, cache)
        lhs = _eval_expr(f["lhs"], inputs, resources, cache)
        rhs = _eval_expr(f["rhs"], inputs, resources, cache)
        lhs, rhs, target = _promote_pair(lhs, rhs, inputs)
        t = jnp.clip(jnp.asarray(amount.data, jnp.float32), 0.0, 1.0)
        if target != NUMBER and not isinstance(t, (int, float)):
            t = t[..., None] if jnp.ndim(t) > 0 else t
        data = lhs.data * (1.0 - t) + rhs.data * t
        return _Value(target, data, amount.uses_wl or lhs.uses_wl or rhs.uses_wl)
    if kind == "clamp":
        value = _eval_number(f["value"], inputs, resources, cache)
        lo = _eval_number(f["min"], inputs, resources, cache)
        hi = _eval_number(f["max"], inputs, resources, cache)
        data = jnp.minimum(jnp.maximum(value.data, lo.data), hi.data)
        return _Value(NUMBER, data, value.uses_wl or lo.uses_wl or hi.uses_wl)
    if kind == "fresnel":
        ior = _eval_number(f["ior"], inputs, resources, cache)
        env_ior = _eval_number(f["env_ior"], inputs, resources, cache)
        value = spectra_mod.fresnel(
            jnp.asarray(ior.data),
            jnp.asarray(env_ior.data),
            _per_ray_channels(inputs.normal, inputs),
            _per_ray_channels(inputs.incident, inputs),
        )
        return _Value(NUMBER, value, ior.uses_wl or env_ior.uses_wl)
    if kind == "blackbody":
        temperature = _eval_number(f["temperature"], inputs, resources, cache)
        return _Value(
            NUMBER, spectra_mod.blackbody(inputs.wavelength, temperature.data), True
        )
    if kind == "spectrum":
        spectrum = resources.spectrum(f["spectrum"])
        return _Value(NUMBER, spectrum.sample(inputs.wavelength), True)
    if kind == "color_texture":
        data = jnp.asarray(resources.color_texture(f["path"], f["linear"]))
        rgba = sample_texture_bicubic(data, inputs.uv)  # [N, 4]
        return _Value(RGB, _per_ray_channels(rgba, inputs), False)
    if kind == "mono_texture":
        data = jnp.asarray(resources.mono_texture(f["path"], f["linear"]))
        luma = sample_texture_bicubic(data, inputs.uv)  # [N]
        return _Value(NUMBER, _per_ray_number(luma, inputs), False)
    raise ir.ProjectError(f"unknown expression kind {kind!r}")


def _common_shape(values):
    shape = ()
    for v in values:
        data = jnp.asarray(v.data)
        shape = jnp.broadcast_shapes(shape, data.shape)
    return shape
