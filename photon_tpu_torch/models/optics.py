"""Optical-system construction and flattening.

Own copy of the JAX package's replacement for the reference's optical-system layer:

* lens design / lensmaker solve —
  ref: run_simulation_02.create_single_lens_optical_system (:33-256) and
  create_camera_optical_system (:259-363)
* rotation utilities — ref: run_simulation_02.calculate_rotation_matrix
  (:366-392) / rotate_coordinates (:395-443)
* element-tree flattening to renderer arrays —
  ref: perform_ray_tracing_03.create_element_coordinate_arrays (:99-345)
* principal-plane / image-distance bookkeeping —
  ref: run_simulation_02.py:867-879, perform_ray_tracing_03.py:2016-2078

The reference represents the optical train as a deeply nested dict tree; we
use a flat dataclass tree (``OpticalAssembly`` of ``OpticalElement`` /
sub-assemblies) and flatten once into an :class:`ElementStack` of numpy
arrays that the renderer consumes.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Union

import numpy as np

from photon_tpu_torch.config import SimulationConfig


# ---------------------------------------------------------------------------
# Rotation helpers
# ---------------------------------------------------------------------------


def rotation_matrix(theta_x: float, theta_y: float, theta_z: float) -> np.ndarray:
    """Rx @ Ry @ Rz with the reference's sign convention.

    (ref: run_simulation_02.calculate_rotation_matrix:366-392 — note the
    transposed-looking signs: R_x has +sin on the upper off-diagonal.)
    """
    cx, sx = np.cos(theta_x), np.sin(theta_x)
    cy, sy = np.cos(theta_y), np.sin(theta_y)
    cz, sz = np.cos(theta_z), np.sin(theta_z)
    rx = np.array([[1.0, 0.0, 0.0], [0.0, cx, sx], [0.0, -sx, cx]])
    ry = np.array([[cy, 0.0, -sy], [0.0, 1.0, 0.0], [sy, 0.0, cy]])
    rz = np.array([[cz, sz, 0.0], [-sz, cz, 0.0], [0.0, 0.0, 1.0]])
    return rx @ ry @ rz


def rotate_coordinates(x, y, z, alpha, beta, gamma, xc=0.0, yc=0.0, zc=0.0):
    """Rotate point clouds about (xc, yc, zc).

    (ref: run_simulation_02.rotate_coordinates:395-443)
    """
    r = rotation_matrix(alpha, beta, gamma)
    pts = np.stack([np.asarray(x) - xc, np.asarray(y) - yc, np.asarray(z) - zc])
    out = r @ pts.reshape(3, -1)
    out = out.reshape(pts.shape)
    return out[0] + xc, out[1] + yc, out[2] + zc


# ---------------------------------------------------------------------------
# Element tree
# ---------------------------------------------------------------------------


@dataclass
class OpticalElement:
    """A single lens / aperture / mirror element."""

    element_type: str = "lens"               # 'lens' | 'aperture' | 'mirror'
    pitch: float = 100.0e3                   # element diameter (microns)
    vertex_distance: float = 10.0e3          # front-to-back vertex thickness
    front_surface_radius: float = +200.0e3
    back_surface_radius: float = -400.0e3
    front_surface_spherical: bool = True
    back_surface_spherical: bool = True
    refractive_index: float = 1.5
    abbe_number: float = float("nan")
    thin_lens_focal_length: float = 85.0e3
    transmission_ratio: float = 1.0
    absorbance_rate: float = 0.0
    z_inter_element_distance: float = 0.0
    axial_offset_distances: Sequence[float] = (0.0, 0.0)
    rotation_angles: Sequence[float] = (0.0, 0.0, 0.0)


@dataclass
class OpticalAssembly:
    """A system of elements and/or nested sub-assemblies along the z axis."""

    elements: List[Union["OpticalAssembly", OpticalElement]] = field(default_factory=list)
    elements_coplanar: bool = False
    z_inter_element_distance: float = 0.0
    axial_offset_distances: Sequence[float] = (0.0, 0.0)
    rotation_angles: Sequence[float] = (0.0, 0.0, 0.0)


@dataclass
class ElementStack:
    """Flattened, renderer-ready optical train (all numpy, static shapes).

    Matches the arrays the reference marshals to the CUDA kernel
    (ref: perform_ray_tracing_03.py:1788-1835):
    per-element centers, plane parameters (a,b,c,d with unit normal),
    sequential system indices and scalar optical properties.
    """

    center: np.ndarray            # (E, 3)
    plane_parameters: np.ndarray  # (E, 4)
    system_index: np.ndarray      # (E,) int
    element_type: np.ndarray      # (E,) int: 0 lens, 1 aperture, 2 mirror
    pitch: np.ndarray             # (E,)
    vertex_distance: np.ndarray   # (E,)
    front_surface_radius: np.ndarray
    back_surface_radius: np.ndarray
    refractive_index: np.ndarray
    abbe_number: np.ndarray
    thin_lens_focal_length: np.ndarray
    transmission_ratio: np.ndarray
    absorbance_rate: np.ndarray

    @property
    def num_elements(self) -> int:
        return int(self.center.shape[0])

    def offset_z(self, z_lens: float) -> "ElementStack":
        """Shift the whole train along z to account for the sensor position.

        (ref: perform_ray_tracing_03.py:2077-2078)
        """
        center = self.center.copy()
        plane = self.plane_parameters.copy()
        plane[:, 3] = plane[:, 3] - plane[:, 2] * z_lens
        center[:, 2] = center[:, 2] + z_lens
        return dataclasses.replace(self, center=center, plane_parameters=plane)


_TYPE_CODES = {"lens": 0, "aperture": 1, "mirror": 2}


def flatten_assembly(assembly: OpticalAssembly) -> ElementStack:
    """Recursively flatten an assembly into renderer arrays.

    Reimplements the geometry semantics of
    ``create_element_coordinate_arrays`` (ref: perform_ray_tracing_03.py:99-345):
    each element sits on a plane normal to +z (after its own rotation),
    sub-assemblies are rotated about the midpoint of their z extent and
    offset laterally, and elements accumulate z along the train.  System
    indices count non-coplanar groups in train order.
    """
    centers: List[np.ndarray] = []
    planes: List[np.ndarray] = []
    sys_idx: List[int] = []
    props: List[OpticalElement] = []

    def visit(node: OpticalAssembly, sys_counter: int) -> tuple:
        total_distance = 0.0     # z-span of elements placed in this node
        system_distance = 0.0    # z offset consumed by sub-assemblies
        start = len(centers)
        for child in node.elements:
            if isinstance(child, OpticalAssembly):
                child_start = len(centers)
                child_span, sys_counter = visit(child, sys_counter)
                rot = rotation_matrix(*child.rotation_angles)
                origin = np.array([0.0, 0.0, child_span / 2.0])
                off = np.asarray(child.axial_offset_distances, dtype=float)
                for i in range(child_start, len(centers)):
                    # rotate plane normal and a point on the plane
                    a, b, c, d = planes[i]
                    normal = rot @ np.array([a, b, c])
                    point = np.array([0.0, 0.0, -d / c])
                    point = rot @ (point - origin) + origin
                    d_new = -float(normal @ point)
                    # rotate the element center about the sub-system midpoint
                    centers[i] = rot @ (centers[i] - origin) + origin
                    centers[i][0] += off[0]
                    centers[i][1] += off[1]
                    centers[i][2] += system_distance
                    d_new -= normal[0] * off[0] + normal[1] * off[1] \
                        + normal[2] * system_distance
                    planes[i] = np.array([normal[0], normal[1], normal[2], d_new])
                system_distance += child_span + child.z_inter_element_distance
            else:
                el: OpticalElement = child
                rot = rotation_matrix(*el.rotation_angles)
                normal = rot @ np.array([0.0, 0.0, 1.0])
                center = np.array([el.axial_offset_distances[0],
                                   el.axial_offset_distances[1],
                                   total_distance])
                plane = np.concatenate([normal, [-normal[2] * center[2]]])
                plane = plane / np.linalg.norm(plane)
                centers.append(center)
                planes.append(plane)
                props.append(el)
                if not node.elements_coplanar:
                    sys_counter += 1
                sys_idx.append(sys_counter)
                # coplanar elements don't advance the train by their thickness
                # (ref: perform_ray_tracing_03.py:290-298)
                total_distance += ((0.0 if node.elements_coplanar
                                    else el.vertex_distance)
                                   + el.z_inter_element_distance)
        del start
        return total_distance + system_distance, sys_counter

    visit(assembly, 0)

    def arr(name, dtype=np.float64):
        return np.array([getattr(p, name) for p in props], dtype=dtype)

    return ElementStack(
        center=np.array(centers, dtype=np.float64),
        plane_parameters=np.array(planes, dtype=np.float64),
        system_index=np.array(sys_idx, dtype=np.int32),
        element_type=np.array([_TYPE_CODES[p.element_type] for p in props],
                              dtype=np.int32),
        pitch=arr("pitch"),
        vertex_distance=arr("vertex_distance"),
        front_surface_radius=arr("front_surface_radius"),
        back_surface_radius=arr("back_surface_radius"),
        refractive_index=arr("refractive_index"),
        abbe_number=arr("abbe_number"),
        thin_lens_focal_length=arr("thin_lens_focal_length"),
        transmission_ratio=arr("transmission_ratio"),
        absorbance_rate=arr("absorbance_rate"),
    )


# ---------------------------------------------------------------------------
# Lens design
# ---------------------------------------------------------------------------


def lensmaker_refractive_index(focal_length: float,
                               radius_of_curvature: float,
                               thickness: float) -> float:
    """Refractive index of a symmetric biconvex thick lens with given f.

    Solves the thick-lens lensmaker equation
    ``1/f = (n-1) [2/R - (n-1) t / (n R^2)]`` for ``n`` (R1 = +R, R2 = -R)
    and returns the smallest real root >= 1 — the same branch choice as the
    reference (ref: run_simulation_02.py:304-317).
    """
    f, R, t = float(focal_length), float(radius_of_curvature), float(thickness)
    # quadratic in n:  a n^2 + b n + c = 0
    a = f * (2.0 * R - t)
    b = -(R * R + 2.0 * f * R - 2.0 * f * t)
    c = -f * t
    if t == 0.0:
        # thin lens limit: n = 1 + R/(2f)
        return 1.0 + R / (2.0 * f)
    roots = np.roots([a, b, c])
    valid = [float(np.real(r)) for r in roots
             if abs(np.imag(r)) < 1e-9 and np.real(r) >= 1.0]
    if not valid:
        raise ValueError("no physical refractive index for this lens design")
    return min(valid)


@dataclass
class CameraSetup:
    """Derived optical quantities consumed by the renderer.

    (ref: run_simulation_02.py:867-879; perform_ray_tracing_03.py:2016-2041)
    """

    lens_pitch: float
    image_distance: float
    h1_principal_plane: float
    h2_principal_plane: float
    v1_vertex_plane: float
    v2_vertex_plane: float
    z_object: float
    z_offset: float
    z_lens: float
    z_sensor: float
    magnification: float
    object_distance: float
    focal_length: float
    aperture_f_number: float
    lens_model: str
    elements: ElementStack
    rotation_matrix: np.ndarray
    inverse_rotation_matrix: np.ndarray


def create_camera_optical_system(cfg: SimulationConfig) -> OpticalAssembly:
    """Single-lens camera assembly from the simulation config.

    (ref: run_simulation_02.create_camera_optical_system:259-363)
    """
    ld = cfg.lens_design
    lens_pitch = ld.focal_length / ld.aperture_f_number
    R = ld.lens_radius_of_curvature
    if ld.lens_model == "thin-lens":
        thickness = 0.0
    else:
        thickness = 2.0 * (R - np.sqrt(R * R - (lens_pitch / 2.0) ** 2))
    n = lensmaker_refractive_index(ld.focal_length, R, thickness)
    lens = OpticalElement(
        element_type="lens",
        pitch=lens_pitch,
        vertex_distance=thickness,
        front_surface_radius=+R,
        back_surface_radius=-R,
        refractive_index=n,
        thin_lens_focal_length=ld.focal_length,
    )
    inner = OpticalAssembly(elements=[lens], elements_coplanar=False,
                            z_inter_element_distance=1.0e4)
    return OpticalAssembly(elements=[inner], elements_coplanar=False)


def camera_setup(cfg: SimulationConfig,
                 assembly: Optional[OpticalAssembly] = None) -> CameraSetup:
    """Flatten the optical train and derive image-space geometry."""
    if assembly is None:
        assembly = create_camera_optical_system(cfg)
    stack = flatten_assembly(assembly)

    ld = cfg.lens_design
    focal_length = ld.focal_length
    object_distance = ld.object_distance
    # the first (front-most) element defines the imaging lens
    n = float(stack.refractive_index[0])
    r1 = float(stack.front_surface_radius[0])
    r2 = float(stack.back_surface_radius[0])
    t = float(stack.vertex_distance[0])

    image_distance = 1.0 / (1.0 / focal_length - 1.0 / object_distance)
    h1 = -(focal_length * (n - 1.0) * t) / (r2 * n)
    h2 = -(focal_length * (n - 1.0) * t) / (r1 * n)
    v2 = image_distance + h2
    v1 = v2 + t
    z_object = v1 - h1 + object_distance
    z_offset = z_object - object_distance
    z_lens = (v1 + v2) / 2.0
    z_sensor = 0.0
    if ld.perturbation is not None:
        z_sensor += ld.perturbation * image_distance
    magnification = focal_length / (object_distance - focal_length)

    rot = rotation_matrix(cfg.camera_design.x_camera_angle,
                          cfg.camera_design.y_camera_angle, 0.0)

    return CameraSetup(
        lens_pitch=focal_length / ld.aperture_f_number,
        image_distance=image_distance,
        h1_principal_plane=h1,
        h2_principal_plane=h2,
        v1_vertex_plane=v1,
        v2_vertex_plane=v2,
        z_object=z_object,
        z_offset=z_offset,
        z_lens=z_lens,
        z_sensor=z_sensor,
        magnification=magnification,
        object_distance=object_distance,
        focal_length=focal_length,
        aperture_f_number=ld.aperture_f_number,
        lens_model=ld.lens_model,
        elements=stack.offset_z(z_lens),
        rotation_matrix=rot,
        inverse_rotation_matrix=rot.T,
    )
