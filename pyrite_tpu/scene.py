"""Scene building: typed IR -> flat device arrays + compiled programs.

This is the array-based replacement for the reference's pointer-based scene
graph (world.rs): triangles/spheres/planes become SoA jnp arrays, materials
become a flattened global component table (materials/mod.rs:89-228 semantics,
including synthesized Mix probability expressions and uniform selection
compensation), and the BVH is built on host and flattened to skip links.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field as dc_field
from typing import Optional

import numpy as np
import jax.numpy as jnp

from . import bvh as bvh_mod
from . import exprs
from . import geometry as geom
from .project import ir

# bsdf type codes
BSDF_EMISSIVE = 0
BSDF_DIFFUSE = 1
BSDF_MIRROR = 2
BSDF_REFRACTIVE = 3

# lamp type codes
LAMP_DIRECTIONAL = 0
LAMP_POINT = 1
LAMP_SPHERE = 2
LAMP_TRIANGLE = 3

# primitive kinds in the BVH
PRIM_TRIANGLE = 0
PRIM_SPHERE = 1

# Above this many primitives, dense sweeps lose to a clustered BVH. This
# also memory-bounds the dense path: its [lanes, prims(chunked), 3]
# intermediates OOM'd at ~5k prims in round 1, so the cluster path takes
# over well below that (the cluster traversal caps its own lane budget).
CLUSTER_THRESHOLD = 1024
# Cluster (BVH leaf) size: each leaf's geometry is packed into ONE
# [CLUSTER_LEAF, 12] row of clu_geo so a parked lane fetches its whole leaf
# with a single row-gather, so larger clusters shift traversal cost from
# serial node-walk gathers to dense intersection sweeps. 128 is also the
# kernel sweep's tile; other sizes are not yet swept on the H100.
CLUSTER_LEAF = 128


def cluster_leaf_size(total_prims: int) -> int:
    """Leaf-cluster size: CLUSTER_LEAF, grown (in steps of 128 — the Pallas
    sweep kernel needs 128-divisible leaf tiles) for scenes whose leaf count
    would exceed the wide tree's 4096-slot capacity."""
    from . import bvh as bvh_mod

    capacity = bvh_mod.WIDE_FANOUT ** bvh_mod.WIDE_LEVELS
    needed = -(-total_prims // capacity)
    return max(CLUSTER_LEAF, -(-needed // 128) * 128)


def pack_wide_clusters_ranges(perm_lo, perm_hi, geo_rows, ranges, leaf_size):
    """Pack explicit (start, count) perm ranges — the SAH treelet cut — into
    fixed-capacity clusters and build the wide 16-ary hierarchy over them.

    Same output contract as pack_wide_clusters, but each cluster's AABB is
    the TIGHT bound of one SAH subtree instead of an arbitrary fixed-size
    chunk of the DFS order (whose snaking bounds made typical terrain rays
    visit ~4x more clusters than needed). Partially filled clusters pad with
    kind = -1 rows that can never intersect."""
    from . import bvh as bvh_mod

    num_leaves = len(ranges)
    geo_p = np.zeros((num_leaves, leaf_size, 12), np.float32)
    geo_p[..., 10] = -1.0
    leaf_lo = np.full((num_leaves, 3), np.inf, np.float32)
    leaf_hi = np.full((num_leaves, 3), -np.inf, np.float32)
    for j, (start, count) in enumerate(ranges):
        geo_p[j, :count] = geo_rows[start : start + count]
        leaf_lo[j] = perm_lo[start : start + count].min(axis=0)
        leaf_hi[j] = perm_hi[start : start + count].max(axis=0)
    rows, slot_of_leaf = bvh_mod.build_wide_bvh(leaf_lo, leaf_hi)

    slots = int(slot_of_leaf.max()) + 1
    geo = np.zeros((slots, leaf_size, 12), np.float32)
    geo[..., 10] = -1.0
    geo[slot_of_leaf] = geo_p
    return rows, geo


def pack_wide_clusters(perm_lo, perm_hi, geo_rows, leaf_size):
    """Chunk the SAH DFS order into full ``leaf_size`` clusters and build the
    wide 16-ary hierarchy over them.

    ``perm_lo``/``perm_hi``/``geo_rows`` are prim AABBs and packed geometry
    rows already in SAH depth-first (spatially coherent) order. Fixed-size
    chunking of that order gives 100%-full leaves (exact flop/byte cost per
    sweep) and an exact leaf count; only the final chunk is padded (with
    kind = -1 rows that can never intersect).

    Returns (rows [273, 128] f32, geo [slots, leaf_size, 12] f32).
    """
    from . import bvh as bvh_mod

    total = len(geo_rows)
    num_leaves = -(-total // leaf_size)
    padded = num_leaves * leaf_size
    geo_p = np.zeros((padded, 12), np.float32)
    geo_p[..., 10] = -1.0
    geo_p[:total] = geo_rows
    lo_p = np.full((padded, 3), np.inf, np.float32)
    hi_p = np.full((padded, 3), -np.inf, np.float32)
    lo_p[:total] = perm_lo
    hi_p[:total] = perm_hi

    leaf_lo = lo_p.reshape(num_leaves, leaf_size, 3).min(axis=1)
    leaf_hi = hi_p.reshape(num_leaves, leaf_size, 3).max(axis=1)
    rows, slot_of_leaf = bvh_mod.build_wide_bvh(leaf_lo, leaf_hi)

    slots = int(slot_of_leaf.max()) + 1
    geo = np.zeros((slots, leaf_size, 12), np.float32)
    geo[..., 10] = -1.0
    geo[slot_of_leaf] = geo_p.reshape(num_leaves, leaf_size, 12)
    return rows, geo


def _mul_expr(lhs, rhs):
    if isinstance(lhs, float) and isinstance(rhs, float):
        return lhs * rhs
    return ir.ComplexExpression("binary", {"operator": "mul", "lhs": lhs, "rhs": rhs})


def _sub_expr(lhs, rhs):
    if isinstance(lhs, float) and isinstance(rhs, float):
        return lhs - rhs
    return ir.ComplexExpression("binary", {"operator": "sub", "lhs": lhs, "rhs": rhs})


def _clamp_expr(value, lo, hi):
    if isinstance(value, float):
        return min(max(value, lo), hi)
    return ir.ComplexExpression("clamp", {"value": value, "min": lo, "max": hi})


@dataclass
class FlatComponent:
    bsdf_type: int
    color: ir.Expression
    probability: Optional[ir.Expression]
    ior: float = 0.0
    env_ior: float = 1.0
    dispersion: float = 0.0
    env_dispersion: float = 0.0


def flatten_material(node: ir.MaterialNode) -> list[FlatComponent]:
    """Material tree -> component list (materials/mod.rs:96-211).

    Mix(lhs, rhs, amount): lhs gets P*clamp(amount); rhs gets 1 - P*clamp(amount).
    Stack order matches the reference (rhs subtree emitted first)."""
    stack = [(node, None)]
    components: list[FlatComponent] = []
    while stack:
        mat, probability = stack.pop()
        kind = mat.kind
        f = mat.fields
        if kind in ("emissive", "diffuse", "mirror"):
            bsdf = {"emissive": BSDF_EMISSIVE, "diffuse": BSDF_DIFFUSE, "mirror": BSDF_MIRROR}[kind]
            components.append(
                FlatComponent(bsdf_type=bsdf, color=f["color"], probability=probability)
            )
        elif kind == "refractive":
            def const(e, default):
                return default if e is None else ir.eval_number(e)

            components.append(
                FlatComponent(
                    bsdf_type=BSDF_REFRACTIVE,
                    color=f["color"],
                    probability=probability,
                    ior=ir.eval_number(f["ior"]),
                    env_ior=const(f.get("env_ior"), 1.0),
                    dispersion=const(f.get("dispersion"), 0.0),
                    env_dispersion=const(f.get("env_dispersion"), 0.0),
                )
            )
        elif kind == "mix":
            amount = _clamp_expr(f["amount"], 0.0, 1.0)
            lhs_probability = (
                amount if probability is None else _mul_expr(probability, amount)
            )
            stack.append((f["lhs"], lhs_probability))
            stack.append((f["rhs"], _sub_expr(1.0, lhs_probability)))
        elif kind == "binary":
            stack.append((f["lhs"], probability))
            stack.append((f["rhs"], probability))
        else:
            raise ir.ProjectError(f"unknown material node {kind!r}")
    return components


@dataclass
class DEShape:
    """A distance-estimated (ray-marched) shape with static parameters."""

    estimator: object  # ir.Mandelbulb | ir.QuaternionJulia with consts evaluated
    bounds_kind: str  # "box" | "sphere"
    bounds_a: np.ndarray  # box min / sphere center
    bounds_b: np.ndarray  # box max / [radius, 0, 0]
    material_id: int


@dataclass
class SceneArrays:
    """All device-resident scene data (jnp arrays)."""

    arrays: dict = dc_field(default_factory=dict)

    def __getitem__(self, key):
        return self.arrays[key]

    def __contains__(self, key):
        return key in self.arrays


class Scene:
    """Host-side scene container: device arrays + compiled program banks."""

    def __init__(self):
        self.arrays: dict = {}
        self.color_programs: list[exprs.CompiledProgram] = []
        self.prob_programs: list[exprs.CompiledProgram] = []
        self.normal_programs: list[exprs.CompiledProgram] = []
        self.de_shapes: list[DEShape] = []
        self.directional_lamps: list = []
        self.sky_program: Optional[exprs.CompiledProgram] = None
        self.num_lamps = 0
        self.lamp_types = set()
        self.num_planes = 0
        self.num_triangles = 0
        self.num_spheres = 0
        self.num_materials = 0
        self.max_components = 1
        self.use_clusters = False
        self.cluster_leaf = 0
        self.cluster_slots = 0
        # bank-table state (bake_bank_tables): per-program bakeable flags, or
        # None when the bank is small enough that the exact per-program loop
        # is both faster and byte-identical to the reference's evaluation
        self.color_bank_bakeable = None
        self.prob_bank_bakeable = None
        self.bank_span = (380.0, 780.0)

    @property
    def num_primitives(self):
        return self.num_triangles + self.num_spheres

    def device_data(self):
        """All device-resident data as a pytree, passed through jit as
        arguments so large scenes/textures never become HLO constants."""
        return {
            "arrays": dict(self.arrays),
            "textures": dict(self.resources.store),
        }

    @contextlib.contextmanager
    def bind(self, data):
        """Temporarily swap in (traced) device data during a jit trace."""
        old_arrays = self.arrays
        old_store = self.resources.store
        self.arrays = data["arrays"]
        self.resources.store = data["textures"]
        try:
            yield
        finally:
            self.arrays = old_arrays
            self.resources.store = old_store


def _look_at_matrix(look: ir.LookAt) -> np.ndarray:
    """Inverted cgmath look_at: camera/object -> world (project/mod.rs:254-269)."""
    eye = ir.eval_vector3(look.from_)
    center = ir.eval_vector3(look.to)
    up = ir.eval_vector3(look.up) if look.up is not None else np.array([0.0, 1.0, 0.0])
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0] = s
    m[:3, 1] = u
    m[:3, 2] = -f
    m[:3, 3] = eye
    return m


def _transform_points(m: np.ndarray, pts: np.ndarray) -> np.ndarray:
    return pts @ m[:3, :3].T + m[:3, 3]


def _transform_vectors(m: np.ndarray, vecs: np.ndarray) -> np.ndarray:
    return vecs @ m[:3, :3].T


def build_scene(project_data) -> Scene:
    project = project_data.project
    resources = exprs.Resources(texture_loader=project_data.textures)
    scene = Scene()
    scene.resources = resources

    # --- program banks with dedup -------------------------------------------
    color_prog_ids: dict[int, int] = {}
    prob_prog_ids: dict[int, int] = {}
    normal_prog_ids: dict[int, int] = {}

    def add_color_program(expr) -> int:
        key = id(expr) if isinstance(expr, ir.ComplexExpression) else ("const", expr)
        if key not in color_prog_ids:
            color_prog_ids[key] = len(scene.color_programs)
            scene.color_programs.append(
                exprs.compile_program(expr, resources, exprs.NUMBER)
            )
        return color_prog_ids[key]

    def add_prob_program(expr) -> int:
        if expr is None:
            return -1
        key = id(expr) if isinstance(expr, ir.ComplexExpression) else ("const", expr)
        if key not in prob_prog_ids:
            prob_prog_ids[key] = len(scene.prob_programs)
            scene.prob_programs.append(
                exprs.compile_program(expr, resources, exprs.NUMBER)
            )
        return prob_prog_ids[key]

    def add_normal_program(expr) -> int:
        if expr is None:
            return -1
        key = id(expr)
        if key not in normal_prog_ids:
            normal_prog_ids[key] = len(scene.normal_programs)
            scene.normal_programs.append(
                exprs.compile_program(expr, resources, exprs.VECTOR)
            )
        return normal_prog_ids[key]

    # --- material table ------------------------------------------------------
    material_ids: dict[int, int] = {}
    mat_comp_offset: list[int] = []
    mat_comp_count: list[int] = []
    mat_emis_offset: list[int] = []
    mat_emis_count: list[int] = []
    mat_normal_prog: list[int] = []

    comp_bsdf: list[int] = []
    comp_color: list[int] = []
    comp_prob: list[int] = []
    comp_color_uses_wl: list[bool] = []
    comp_prob_uses_wl: list[bool] = []
    comp_selection: list[float] = []
    comp_ior: list[float] = []
    comp_env_ior: list[float] = []
    comp_disp: list[float] = []
    comp_env_disp: list[float] = []

    emis_comp: list[int] = []
    emis_selection: list[float] = []

    def add_material(material: ir.Material) -> int:
        key = id(material.surface), id(material.normal_map)
        if key in material_ids:
            return material_ids[key]
        mid = len(mat_comp_offset)
        material_ids[key] = mid

        flat = flatten_material(material.surface)
        mat_comp_offset.append(len(comp_bsdf))
        mat_comp_count.append(len(flat))
        mat_normal_prog.append(add_normal_program(material.normal_map))

        emissive_indices = []
        for comp in flat:
            idx = len(comp_bsdf)
            comp_bsdf.append(comp.bsdf_type)
            cp = add_color_program(comp.color)
            comp_color.append(cp)
            comp_color_uses_wl.append(scene.color_programs[cp].uses_wavelength)
            pp = add_prob_program(comp.probability)
            comp_prob.append(pp)
            comp_prob_uses_wl.append(
                pp >= 0 and scene.prob_programs[pp].uses_wavelength
            )
            comp_selection.append(float(len(flat)))
            comp_ior.append(comp.ior)
            comp_env_ior.append(comp.env_ior)
            comp_disp.append(comp.dispersion)
            comp_env_disp.append(comp.env_dispersion)
            if comp.bsdf_type == BSDF_EMISSIVE:
                emissive_indices.append(idx)

        mat_emis_offset.append(len(emis_comp))
        mat_emis_count.append(len(emissive_indices))
        for idx in emissive_indices:
            emis_comp.append(idx)
            emis_selection.append(float(len(emissive_indices)))
        return mid

    def material_is_emissive(mid: int) -> bool:
        return mat_emis_count[mid] > 0

    # --- geometry ------------------------------------------------------------
    tri_v0, tri_e1, tri_e2 = [], [], []
    tri_n, tri_q, tri_uv, tri_mat = [], [], [], []
    sph_center, sph_radius, sph_texscale, sph_mat = [], [], [], []
    pla_normal, pla_d, pla_quat, pla_texscale, pla_mat = [], [], [], [], []

    lamp_type, lamp_ref, lamp_vec, lamp_width, lamp_color = [], [], [], [], []

    def texscale_of(e) -> np.ndarray:
        if e is None:
            return np.array([1.0, 1.0], np.float32)
        v = ir.eval_vector4(e)
        return np.array([v[0], v[1]], np.float32)

    def np_basis(v):
        # the reference's ortho/basis in numpy, for host-side plane frames
        if abs(v[0]) < geom.DIST_EPSILON:
            unit = np.array([1.0, 0.0, 0.0])
        elif abs(v[1]) < geom.DIST_EPSILON:
            unit = np.array([0.0, 1.0, 0.0])
        elif abs(v[2]) < geom.DIST_EPSILON:
            unit = np.array([0.0, 0.0, 1.0])
        else:
            unit = np.array([-v[1], v[0], 0.0])
        z = np.cross(v, unit)
        z = z / np.linalg.norm(z)
        y = np.cross(z, v)
        y = y / np.linalg.norm(y)
        return y, z

    def add_mesh_triangles(obj_mesh, faces_v, faces_vt, faces_vn, mid, scale, transform):
        positions = obj_mesh.positions
        normals_pool = obj_mesh.normals
        uv_pool = obj_mesh.texcoords

        v = positions[faces_v]  # [T, 3, 3]
        has_n = np.all(faces_vn >= 0, axis=1)
        n = np.where(
            has_n[:, None, None],
            normals_pool[np.maximum(faces_vn, 0)] if len(normals_pool) else np.zeros_like(v),
            0.0,
        )
        # compute face normals where vertex normals are missing
        e1 = v[:, 1] - v[:, 0]
        e2 = v[:, 2] - v[:, 0]
        face_n = np.cross(e1, e2)
        face_n /= np.maximum(np.linalg.norm(face_n, axis=1, keepdims=True), 1e-20)
        n = np.where(has_n[:, None, None], n, face_n[:, None, :])

        has_t = faces_vt >= 0
        uv = np.where(
            has_t[:, :, None],
            uv_pool[np.maximum(faces_vt, 0)] if len(uv_pool) else np.zeros((1, 2)),
            0.0,
        )

        # tangent frame from UV deltas (world.rs:344-352)
        dt1 = uv[:, 1] - uv[:, 0]
        dt2 = uv[:, 2] - uv[:, 0]
        denom = dt1[:, 0] * dt2[:, 1] - dt1[:, 1] * dt2[:, 0]
        r = 1.0 / np.where(np.abs(denom) < 1e-30, np.inf, denom)
        tangent = (e1 * dt2[:, 1:2] - e2 * dt1[:, 1:2]) * r[:, None]
        bitangent = (e2 * dt1[:, 0:1] - e1 * dt2[:, 0:1]) * r[:, None]

        # scale then transform (world.rs:221-223)
        v = v * scale
        if transform is not None:
            v = _transform_points(transform, v.reshape(-1, 3)).reshape(v.shape)
            n_flat = _transform_vectors(transform, n.reshape(-1, 3))
            n_flat /= np.maximum(np.linalg.norm(n_flat, axis=1, keepdims=True), 1e-20)
            n = n_flat.reshape(n.shape)
            tangent = _transform_vectors(transform, tangent)
            bitangent = _transform_vectors(transform, bitangent)

        e1 = v[:, 1] - v[:, 0]
        e2 = v[:, 2] - v[:, 0]

        # per-vertex frame quaternion: Matrix3(tangent, bitangent, n_vertex)
        quats = geom.mat3_cols_to_quat(
            np.repeat(tangent[:, None, :], 3, axis=1).reshape(-1, 3),
            np.repeat(bitangent[:, None, :], 3, axis=1).reshape(-1, 3),
            n.reshape(-1, 3),
        ).reshape(-1, 3, 4)

        start = len(tri_v0)
        for i in range(len(v)):
            tri_v0.append(v[i, 0])
            tri_e1.append(e1[i])
            tri_e2.append(e2[i])
            tri_n.append(n[i])
            tri_q.append(quats[i])
            tri_uv.append(uv[i])
            tri_mat.append(mid)
        return start, len(v)

    for obj in project.world.objects:
        if isinstance(obj, ir.Sphere):
            mid = add_material(obj.material)
            idx = len(sph_center)
            sph_center.append(ir.eval_vector3(obj.position))
            sph_radius.append(ir.eval_number(obj.radius))
            sph_texscale.append(texscale_of(obj.texture_scale))
            sph_mat.append(mid)
            if material_is_emissive(mid):
                lamp_type.append(LAMP_SPHERE)
                lamp_ref.append(idx)
                lamp_vec.append(np.zeros(3, np.float32))
                lamp_width.append(0.0)
                lamp_color.append(-1)
        elif isinstance(obj, ir.Plane):
            mid = add_material(obj.material)
            normal = ir.eval_vector3(obj.normal)
            normal = normal / np.linalg.norm(normal)
            origin = ir.eval_vector3(obj.origin)
            binormal, tangent = np_basis(normal)
            quat = geom.mat3_cols_to_quat(
                binormal[None], tangent[None], normal[None]
            )[0]
            pla_normal.append(normal)
            # The reference's collision crate stores d = n.origin but its ray
            # test solves n.x + d = 0, so every plane is effectively mirrored
            # through the world origin (verified against dragon.lua, whose
            # walls at y=-10/x=-11 only make sense as backdrops at y=+10/x=+11
            # behind the model). We reproduce that behavior: n.x = -(n.origin).
            pla_d.append(float(-np.dot(normal, origin)))
            pla_quat.append(quat)
            pla_texscale.append(texscale_of(obj.texture_scale))
            pla_mat.append(mid)
            if material_is_emissive(mid):
                print(
                    "Warning: emissive planes may not always produce correct results."
                )
        elif isinstance(obj, ir.Mesh):
            obj_mesh = project_data.meshes.load(obj.file)
            scale = 1.0 if obj.scale is None else ir.eval_number(obj.scale)
            transform = None if obj.transform is None else _look_at_matrix(obj.transform)
            for mesh_obj in obj_mesh.objects:
                if mesh_obj.name not in obj.materials:
                    raise ir.ProjectError(
                        f"missing material for '{mesh_obj.name}'"
                    )
                mid = add_material(obj.materials[mesh_obj.name])
                start, count = add_mesh_triangles(
                    obj_mesh,
                    mesh_obj.faces_v,
                    mesh_obj.faces_vt,
                    mesh_obj.faces_vn,
                    mid,
                    scale,
                    transform,
                )
                if material_is_emissive(mid):
                    for t in range(start, start + count):
                        lamp_type.append(LAMP_TRIANGLE)
                        lamp_ref.append(t)
                        lamp_vec.append(np.zeros(3, np.float32))
                        lamp_width.append(0.0)
                        lamp_color.append(-1)
        elif isinstance(obj, ir.RayMarched):
            mid = add_material(obj.material)
            est = obj.shape
            if isinstance(est, ir.Mandelbulb):
                estimator = {
                    "kind": "mandelbulb",
                    "iterations": int(ir.eval_number(est.iterations)),
                    "threshold": ir.eval_number(est.threshold),
                    "power": ir.eval_number(est.power),
                    "constant": None
                    if est.constant is None
                    else ir.eval_vector3(est.constant),
                }
            else:
                estimator = {
                    "kind": "quaternion_julia",
                    "iterations": int(ir.eval_number(est.iterations)),
                    "threshold": ir.eval_number(est.threshold),
                    "constant": ir.eval_vector4(est.constant),
                    "slice_plane": ir.eval_number(est.slice_plane),
                    "variant": est.variant,
                }
            if isinstance(obj.bounds, ir.BoundingBox):
                bounds_kind = "box"
                a = ir.eval_vector3(obj.bounds.min)
                b = ir.eval_vector3(obj.bounds.max)
            else:
                bounds_kind = "sphere"
                a = ir.eval_vector3(obj.bounds.position)
                b = np.array([ir.eval_number(obj.bounds.radius), 0.0, 0.0], np.float32)
            if material_is_emissive(mid):
                print(
                    "Warning: emissive, distance estimated shapes may not "
                    "always produce correct results."
                )
            scene.de_shapes.append(
                DEShape(
                    estimator=estimator,
                    bounds_kind=bounds_kind,
                    bounds_a=a.astype(np.float32),
                    bounds_b=b.astype(np.float32),
                    material_id=mid,
                )
            )
        elif isinstance(obj, ir.DirectionalLight):
            lamp_type.append(LAMP_DIRECTIONAL)
            lamp_ref.append(-1)
            lamp_vec.append(ir.eval_vector3(obj.direction).astype(np.float32))
            lamp_width.append(ir.eval_number(obj.width))
            lamp_color.append(add_color_program(obj.color))
        elif isinstance(obj, ir.PointLight):
            lamp_type.append(LAMP_POINT)
            lamp_ref.append(-1)
            lamp_vec.append(ir.eval_vector3(obj.position).astype(np.float32))
            lamp_width.append(0.0)
            lamp_color.append(add_color_program(obj.color))
        else:
            raise ir.ProjectError(f"unsupported world object {type(obj).__name__}")

    # --- sky -------------------------------------------------------------------
    sky = project.world.sky if project.world.sky is not None else 0.0
    scene.sky_program = exprs.compile_program(sky, resources, exprs.NUMBER)

    # --- BVH over finite primitives (triangles + spheres) ------------------------
    num_tris = len(tri_v0)
    num_sph = len(sph_center)
    prim_kind = np.concatenate(
        [
            np.full(num_tris, PRIM_TRIANGLE, np.int32),
            np.full(num_sph, PRIM_SPHERE, np.int32),
        ]
    )
    prim_ref = np.concatenate(
        [np.arange(num_tris, dtype=np.int32), np.arange(num_sph, dtype=np.int32)]
    )
    if num_tris:
        t_v0 = np.asarray(tri_v0, np.float32)
        t_e1 = np.asarray(tri_e1, np.float32)
        t_e2 = np.asarray(tri_e2, np.float32)
        t_lo = np.minimum(np.minimum(t_v0, t_v0 + t_e1), t_v0 + t_e2)
        t_hi = np.maximum(np.maximum(t_v0, t_v0 + t_e1), t_v0 + t_e2)
    else:
        t_lo = np.zeros((0, 3), np.float32)
        t_hi = np.zeros((0, 3), np.float32)
    if num_sph:
        s_c = np.asarray(sph_center, np.float32)
        s_r = np.asarray(sph_radius, np.float32)[:, None]
        s_lo, s_hi = s_c - s_r, s_c + s_r
    else:
        s_lo = np.zeros((0, 3), np.float32)
        s_hi = np.zeros((0, 3), np.float32)
    prim_lo = np.concatenate([t_lo, s_lo])
    prim_hi = np.concatenate([t_hi, s_hi])

    # Large scenes traverse a clustered BVH: compact top-level tree whose
    # leaves are contiguous ranges of up to CLUSTER_LEAF primitives, tested
    # with dense (vectorizable) sweeps. Small scenes skip the tree entirely
    # (dense sweep over everything), so the classic flat BVH is only a
    # fallback when the native builder is unavailable.
    scene.use_clusters = False
    total_prims = num_tris + num_sph
    if total_prims > CLUSTER_THRESHOLD:
        # the binary SAH build is used only for its depth-first primitive
        # ORDER (spatially coherent); a small leaf size gives a finer order
        order_leaf = 32
        try:
            from . import native

            clustered = native.build_bvh_clustered(prim_lo, prim_hi, order_leaf)
        except Exception:
            clustered = None
        if clustered is None:
            # no native toolchain: numpy clustered build, same contract
            # (the flat-BVH traversal is a test oracle, not a device path)
            clustered = bvh_mod.build_bvh_clustered_python(
                prim_lo, prim_hi, order_leaf
            )
        if clustered is not None:
            perm = clustered[5]
            prim_kind = prim_kind[perm]
            prim_ref = prim_ref[perm]
            scene.use_clusters = True
            # perm-ordered packed geometry rows (v0/center, e1, e2, radius,
            # kind, ref), one [12] f32 row per primitive
            geo = np.zeros((total_prims, 12), np.float32)
            tm = prim_kind == PRIM_TRIANGLE
            sm = ~tm
            if tm.any():
                tr = prim_ref[tm]
                geo[tm, 0:3] = t_v0[tr]
                geo[tm, 3:6] = t_e1[tr]
                geo[tm, 6:9] = t_e2[tr]
            if sm.any():
                sr = prim_ref[sm]
                geo[sm, 0:3] = s_c[sr]
                geo[sm, 9] = np.asarray(sph_radius, np.float32)[sr]
            geo[:, 10] = prim_kind
            geo[:, 11] = prim_ref
            leaf_size = cluster_leaf_size(total_prims)
            capacity = bvh_mod.WIDE_FANOUT ** bvh_mod.WIDE_LEVELS
            subtree, start, count = clustered[2], clustered[3], clustered[4]
            while True:
                ranges = bvh_mod.treelet_ranges(subtree, start, count, leaf_size)
                if len(ranges) <= capacity:
                    break
                try:
                    ranges = bvh_mod.merge_ranges(ranges, leaf_size, capacity)
                    break
                except ValueError:
                    leaf_size += 128  # denser clusters until the tree fits
            rows, packed_geo = pack_wide_clusters_ranges(
                prim_lo[perm], prim_hi[perm], geo, ranges, leaf_size
            )
            scene.cluster_leaf = leaf_size
            scene.cluster_slots = packed_geo.shape[0]
            scene.arrays["wide_rows"] = jnp.asarray(rows)
            scene.arrays["clu_geo"] = jnp.asarray(packed_geo)
            from . import kernels

            # channel-major copy for the kernel leaf sweep
            scene.arrays["clu_geo_ch"] = jnp.asarray(
                kernels.pack_geo_channel_major(packed_geo)
            )
    # small scenes use the dense sweep; large ones the clustered traversal —
    # the flat BVH (bvh.traverse) is a test oracle, never a device path
    assert scene.use_clusters or total_prims <= CLUSTER_THRESHOLD

    def as_jnp(x, dtype=jnp.float32):
        return jnp.asarray(np.asarray(x, dtype))

    def pad1(lst, dtype, pad_value=0, width=None):
        """1-sized padding so zero-length scenes still trace."""
        arr = np.asarray(lst, dtype)
        if len(arr) == 0:
            shape = (1,) if width is None else (1, *width)
            arr = np.full(shape, pad_value, dtype)
        return jnp.asarray(arr)

    a = scene.arrays
    a["tri_v0"] = pad1(tri_v0, np.float32, 0, (3,))
    a["tri_e1"] = pad1(tri_e1, np.float32, 0, (3,))
    a["tri_e2"] = pad1(tri_e2, np.float32, 0, (3,))
    a["tri_n"] = pad1(tri_n, np.float32, 0, (3, 3))
    a["tri_q"] = pad1(tri_q, np.float32, 0, (3, 4))
    a["tri_uv"] = pad1(tri_uv, np.float32, 0, (3, 2))
    a["tri_mat"] = pad1(tri_mat, np.int32)
    a["sph_center"] = pad1(sph_center, np.float32, 0, (3,))
    a["sph_radius"] = pad1(sph_radius, np.float32, 1)
    a["sph_texscale"] = pad1(sph_texscale, np.float32, 1, (2,))
    a["sph_mat"] = pad1(sph_mat, np.int32)
    a["pla_normal"] = pad1(pla_normal, np.float32, 0, (3,))
    a["pla_d"] = pad1(pla_d, np.float32)
    a["pla_quat"] = pad1(pla_quat, np.float32, 0, (4,))
    a["pla_texscale"] = pad1(pla_texscale, np.float32, 1, (2,))
    a["pla_mat"] = pad1(pla_mat, np.int32)
    scene.num_planes = len(pla_normal)

    a["prim_kind"] = pad1(prim_kind, np.int32)
    a["prim_ref"] = pad1(prim_ref, np.int32)

    a["mat_comp_offset"] = pad1(mat_comp_offset, np.int32)
    a["mat_comp_count"] = pad1(mat_comp_count, np.int32, 1)
    a["mat_emis_offset"] = pad1(mat_emis_offset, np.int32)
    a["mat_emis_count"] = pad1(mat_emis_count, np.int32)
    a["mat_normal_prog"] = pad1(mat_normal_prog, np.int32, -1)
    a["comp_bsdf"] = pad1(comp_bsdf, np.int32)
    a["comp_color"] = pad1(comp_color, np.int32)
    a["comp_prob"] = pad1(comp_prob, np.int32, -1)
    a["comp_color_uses_wl"] = pad1(comp_color_uses_wl, bool, False)
    a["comp_prob_uses_wl"] = pad1(comp_prob_uses_wl, bool, False)
    a["comp_selection"] = pad1(comp_selection, np.float32, 1)
    a["comp_ior"] = pad1(comp_ior, np.float32, 1)
    a["comp_env_ior"] = pad1(comp_env_ior, np.float32, 1)
    a["comp_disp"] = pad1(comp_disp, np.float32)
    a["comp_env_disp"] = pad1(comp_env_disp, np.float32)
    a["emis_comp"] = pad1(emis_comp, np.int32)
    a["emis_selection"] = pad1(emis_selection, np.float32, 1)

    a["lamp_type"] = pad1(lamp_type, np.int32, LAMP_POINT)
    a["lamp_ref"] = pad1(lamp_ref, np.int32, -1)
    a["lamp_vec"] = pad1(lamp_vec, np.float32, 0, (3,))
    a["lamp_width"] = pad1(lamp_width, np.float32)
    a["lamp_color"] = pad1(lamp_color, np.int32, -1)
    scene.num_lamps = len(lamp_type)
    scene.num_materials = len(mat_comp_offset)
    scene.num_triangles = num_tris
    scene.num_spheres = num_sph
    scene.max_components = max([1] + mat_comp_count)
    scene.lamp_types = set(lamp_type)
    # host-side list of directional lamps for the miss path (tracer.rs:444-459)
    scene.directional_lamps = [
        (np.asarray(lamp_vec[i], np.float32), float(lamp_width[i]), int(lamp_color[i]))
        for i in range(len(lamp_type))
        if lamp_type[i] == LAMP_DIRECTIONAL
    ]

    bake_bank_tables(scene, project.renderer.spectrum_span)
    return scene


# Program banks switch from the exact per-program masked loop (O(P) evals
# per bounce — fine for the reference scenes' <=10 programs) to one shared
# interpolation table once this many lambda-only programs exist.
BANK_TABLE_MIN = 8
BANK_GRID = 4096  # ~0.1 nm spacing over a 400 nm span


def bake_bank_tables(scene: Scene, span) -> None:
    """Bake lambda-only color/probability programs into [P, BANK_GRID]
    lookup tables (linear interpolation at eval time).

    The reference evaluates the hit material's program per thread — O(1)
    per ray (program/execution_context.rs). The wavefront bank loop
    (tracer.eval_color_bank) is O(P) per ray; for material-heavy scenes the
    table turns that into one flat gather + lerp regardless of P. Programs
    that read uv/normal/incident (textures, fresnel) stay on the loop path;
    tables only activate when >= BANK_TABLE_MIN lambda-only programs exist,
    so small scenes keep exact (non-interpolated) evaluation."""
    import contextlib as _ctx

    import jax
    import jax.numpy as jnp

    lam = np.linspace(span[0], span[1], BANK_GRID).astype(np.float32)

    def bake(progs, key):
        bakeable = [not p.uses_ray_inputs for p in progs]
        if sum(bakeable) < BANK_TABLE_MIN:
            return None
        table = np.zeros((len(progs), BANK_GRID), np.float32)
        # evaluate on the host CPU backend: this is un-jitted per-op work,
        # and each op dispatched to an accelerator pays a launch
        try:
            ctx = jax.default_device(jax.devices("cpu")[0])
        except RuntimeError:
            ctx = _ctx.nullcontext()
        with ctx:
            wl = jnp.asarray(lam)
            for i, (prog, ok) in enumerate(zip(progs, bakeable)):
                if not ok:
                    continue
                if prog.constant is not None:
                    table[i, :] = prog.constant
                else:
                    table[i, :] = np.broadcast_to(
                        np.asarray(
                            prog.fn(exprs.ProgramInputs(wavelength=wl)),
                            np.float32,
                        ),
                        (BANK_GRID,),
                    )
        scene.arrays[key] = table
        return bakeable

    scene.color_bank_bakeable = bake(scene.color_programs, "color_bank")
    scene.prob_bank_bakeable = bake(scene.prob_programs, "prob_bank")
    scene.bank_span = (float(span[0]), float(span[1]))


@dataclass
class CameraModel:
    """Thin-lens perspective camera (cameras.rs)."""

    transform: np.ndarray  # 4x4 camera->world
    view_plane: float
    focus_distance: float
    aperture: float

    @staticmethod
    def from_ir(cam: ir.Camera) -> "CameraModel":
        fov = ir.eval_number(cam.fov)
        half = math.radians(fov * 0.5)
        view_plane = math.cos(half) / math.sin(half)
        return CameraModel(
            transform=_look_at_matrix(cam.transform),
            view_plane=view_plane,
            focus_distance=1.0
            if cam.focus_distance is None
            else ir.eval_number(cam.focus_distance),
            aperture=0.0 if cam.aperture is None else ir.eval_number(cam.aperture),
        )

    def ray_towards(self, target_xy, u1, u2):
        """Batched primary ray generation (cameras.rs:70-97).

        ``target_xy``: [N, 2] view-plane coordinates; u1/u2: [N] uniforms.
        Returns (origin [N, 3], direction [N, 3])."""
        focus_x = target_xy[:, 0] / self.view_plane * self.focus_distance
        focus_y = target_xy[:, 1] / self.view_plane * self.focus_distance
        target = jnp.stack(
            [focus_x, -focus_y, jnp.full_like(focus_x, -self.focus_distance)], axis=-1
        )
        if self.aperture > 0.0:
            sqrt_r = jnp.sqrt(self.aperture * u1)
            psi = 2.0 * jnp.pi * u2
            origin = jnp.stack(
                [sqrt_r * jnp.cos(psi), sqrt_r * jnp.sin(psi), jnp.zeros_like(u1)],
                axis=-1,
            )
            direction = geom.normalize(target - origin)
        else:
            origin = jnp.zeros_like(target)
            direction = geom.normalize(target)
        m = jnp.asarray(self.transform)
        world_origin = origin @ m[:3, :3].T + m[:3, 3]
        world_dir = direction @ m[:3, :3].T
        return world_origin, world_dir


def camera_inverse_project(camera: CameraModel, targets, u1, u2):
    """Project world points back through the lens to film coordinates
    (cameras.rs:99-158 is_visible, minus the world occlusion test).

    Returns (view_xy [N, 2], world_origin [N, 3], direction [N, 3],
    distance [N], ok [N])."""
    m = jnp.asarray(camera.transform)
    rot = m[:3, :3]
    trans = m[:3, 3]
    # inverse of a rigid transform: R^T, -R^T t
    local = (targets - trans) @ rot
    ok = local[:, 2] < 0.0

    if camera.aperture > 0.0:
        sqrt_r = jnp.sqrt(camera.aperture * u1)
        psi = 2.0 * jnp.pi * u2
        origin_local = jnp.stack(
            [sqrt_r * jnp.cos(psi), sqrt_r * jnp.sin(psi), jnp.zeros_like(u1)],
            axis=-1,
        )
    else:
        origin_local = jnp.zeros_like(targets)

    world_origin = origin_local @ rot.T + trans
    direction = targets - world_origin
    distance = jnp.sqrt(jnp.maximum(jnp.sum(direction * direction, axis=-1), 1e-20))
    direction = direction / distance[:, None]

    fd = camera.focus_distance
    l1 = local + jnp.asarray([0.0, 0.0, fd])
    dist_z = l1[:, 2]
    l2 = l1 - origin_local * (dist_z / fd)[:, None]
    l3 = l2 - jnp.asarray([0.0, 0.0, fd])
    denom = jnp.where(jnp.abs(l3[:, 2]) < 1e-12, 1.0, l3[:, 2])
    vpt = -l3 / denom[:, None]
    target_x = vpt[:, 0] * camera.view_plane
    target_y = -vpt[:, 1] * camera.view_plane
    return jnp.stack([target_x, target_y], axis=-1), world_origin, direction, distance, ok
