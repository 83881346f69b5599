"""3-D-printable mask fabrication (port of lenslesspicam_tpu/hardware/fabrication.py,
host code copied; reference: lensless/hardware/fabrication.py:27-525).

Generates CadQuery solids for masks: frames, connections that hold
free-floating mask parts, multi-lens molds, and sensor adapters.

Design: every frame/connection computes its GEOMETRY (rectangles,
polygon vertices, joint points) as pure numpy — testable without any
CAD dependency — and a thin ``generate`` turns the geometry into a
CadQuery solid.  cadquery itself is gated: it is not available in
compute-only environments and is only required at ``generate``/``save``
time.

All linear dimensions on the CAD side are millimeters; mask sizes
arrive in meters (as the mask classes store them) and are converted.
``from_mask`` reads the port's mask classes (hardware/mask.py) and takes
their arrays to the host.
"""

from __future__ import annotations

import os

import numpy as np


def _host(x) -> np.ndarray:
    """``x`` as a numpy array on the host, its dtype kept (a tensor on any
    device is detached and copied over)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _require_cadquery():
    try:
        import cadquery as cq

        return cq
    except ImportError as e:
        raise ImportError(
            "Mask fabrication requires cadquery; install it on a host "
            "machine (not needed for reconstruction/training)."
        ) from e


# --------------------------------------------------------------------
# frames
# --------------------------------------------------------------------


class SimpleFrame:
    """Rectangular frame around the mask area (fabrication.py:388-414).

    Specify either ``padding`` (mm added around the mask) or an explicit
    ``size`` (mm); size wins.
    """

    def __init__(self, padding: float = 2.0, size=None):
        self.padding = padding
        self.size = size

    def outline(self, mask_size):
        """(outer_w, outer_h, inner_w, inner_h) in mm — pure geometry."""
        width, height = float(mask_size[0]), float(mask_size[1])
        size = (self.size if self.size is not None
                else (width + 2 * self.padding, height + 2 * self.padding))
        return (float(size[0]), float(size[1]), width, height)

    def generate(self, mask_size, depth: float):
        cq = _require_cadquery()
        ow, oh, iw, ih = self.outline(mask_size)
        return (
            cq.Workplane("XY")
            .box(ow, oh, depth, centered=(True, True, False))
            .rect(iw, ih)
            .cutThruAll()
        )


# --------------------------------------------------------------------
# connections for free-floating parts
# --------------------------------------------------------------------


class CrossConnection:
    """Transverse '+' connection (fabrication.py:417-438): one vertical
    and one horizontal bar of ``line_width`` through the mask center,
    optionally cut by a circle of ``mask_radius`` (so the bars stop at
    the mask's solid annulus)."""

    def __init__(self, line_width: float = 0.1, mask_radius: float = None):
        self.line_width = line_width
        self.mask_radius = mask_radius

    def bars(self, mask_size):
        """Two centered (w, h) bar rectangles in mm — pure geometry."""
        width, height = float(mask_size[0]), float(mask_size[1])
        return [(self.line_width, height), (width, self.line_width)]

    def generate(self, mask, mask_size, depth: float):
        cq = _require_cadquery()
        (bw1, bh1), (bw2, bh2) = self.bars(mask_size)
        model = (
            cq.Workplane("XY")
            .box(bw1, bh1, depth, centered=(True, True, False))
            .box(bw2, bh2, depth, centered=(True, True, True))
        )
        if self.mask_radius is not None:
            circle = cq.Workplane("XY").cylinder(
                depth, self.mask_radius, centered=(True, True, False))
            model = model.cut(circle)
        return model


class SaltireConnection:
    """Diagonal 'x' connection (fabrication.py:441-478): two corner-to-
    corner strips of ``line_width``, built as hexagonal polygons."""

    def __init__(self, line_width: float = 0.1, mask_radius: float = None):
        self.line_width = line_width
        self.mask_radius = mask_radius

    def polygons(self, mask_size):
        """Two 6-vertex polygons (mm, (x, y) tuples) — pure geometry."""
        width, height = float(mask_size[0]), float(mask_size[1])
        w2, h2 = width / 2, height / 2
        lw = self.line_width / np.sqrt(2)
        diag1 = [(-(w2 - lw), -h2), (-w2, -h2), (-w2, -(h2 - lw)),
                 (w2 - lw, h2), (w2, h2), (w2, h2 - lw)]
        diag2 = [(-(w2 - lw), h2), (-w2, h2), (-w2, h2 - lw),
                 (w2 - lw, -h2), (w2, -h2), (w2, -(h2 - lw))]
        return [diag1, diag2]

    def generate(self, mask, mask_size, depth: float):
        cq = _require_cadquery()
        model = cq.Workplane("XY")
        for poly in self.polygons(mask_size):
            model = model.moveTo(*poly[0])
            for pt in poly[1:]:
                model = model.lineTo(*pt)
            model = model.close().extrude(depth)
        if self.mask_radius is not None:
            circle = cq.Workplane("XY").cylinder(
                depth, self.mask_radius, centered=(True, True, False))
            model = model.cut(circle)
        return model


class ThreePointConnection:
    """Three-point connection for free-floating rings as in the
    FresnelZoneAperture (fabrication.py:481-519): one horizontal bar to
    the right edge and two tapered strips to the left corners."""

    def __init__(self, line_width: float = 0.1, mask_radius: float = None):
        self.line_width = line_width
        self.mask_radius = mask_radius

    def geometry(self, mask_size):
        """(bar_rect, [poly1, poly2]) in mm — pure geometry.  bar_rect is
        (w, h) anchored at the center extending right."""
        width, height = float(mask_size[0]), float(mask_size[1])
        w2, h2 = width / 2, height / 2
        lw = self.line_width / np.sqrt(2)
        bar = (w2, self.line_width)
        poly1 = [(-(w2 - lw), -h2), (-w2, -h2), (-w2, -(h2 - lw)),
                 (-lw, 0.0), (lw, 0.0)]
        poly2 = [(-(w2 - lw), h2), (-w2, h2), (-w2, h2 - lw),
                 (-lw, 0.0), (lw, 0.0)]
        return bar, [poly1, poly2]

    def generate(self, mask, mask_size, depth: float):
        cq = _require_cadquery()
        bar, polys = self.geometry(mask_size)
        model = cq.Workplane("XY").box(bar[0], bar[1], depth,
                                       centered=(False, True, False))
        for poly in polys:
            model = model.moveTo(*poly[0])
            for pt in poly[1:]:
                model = model.lineTo(*pt)
            model = model.close().extrude(depth)
        if self.mask_radius is not None:
            circle = cq.Workplane("XY").cylinder(
                depth, self.mask_radius, centered=(True, True, False))
            model = model.cut(circle)
        return model


class CodedApertureConnection:
    """Joint cylinders at the cell-grid crossings of a separable coded
    aperture (fabrication.py:503-525): posts are placed wherever the
    first row/column change value, i.e. at interior cell boundaries, so
    every floating cell is pinned."""

    def __init__(self, joint_radius: float = 0.1):
        self.joint_radius = joint_radius

    def joint_points(self, mask: np.ndarray, mask_size):
        """(N, 2) joint coordinates in mm — pure geometry."""
        mask = np.asarray(mask)
        x_lines = np.where(np.diff(mask[:, 0]) != 0)[0] + 1
        y_lines = np.where(np.diff(mask[0]) != 0)[0] + 1
        X, Y = np.meshgrid(x_lines, y_lines)
        point_idxs = (np.vstack([X.ravel(), Y.ravel()]).T
                      - np.array(mask.shape) / 2)
        px_size = np.asarray(mask_size, float) / np.array(mask.shape)
        return point_idxs * px_size

    def generate(self, mask, mask_size, depth: float):
        cq = _require_cadquery()
        points = self.joint_points(mask, mask_size)
        return (
            cq.Workplane("XY")
            .pushPoints([tuple(p) for p in points])
            .cylinder(depth, self.joint_radius,
                      centered=(True, True, False), combine=False)
        )


# --------------------------------------------------------------------
# models
# --------------------------------------------------------------------


class Mask3DModel:
    """Binary (or graded 3-D) mask -> printable solid
    (fabrication.py:40-220).

    1 is opaque, 0 is transparent; opaque cells are extruded boxes of
    ``height`` mm (scaled per-cell for graded masks).  A frame and a
    connection solid hold free-floating parts.
    """

    def __init__(self, mask_array, mask_size, height=None, frame=None,
                 connection=None, simplify: bool = False,
                 show_axis: bool = False, generate: bool = True):
        self.mask = np.asarray(mask_array)
        mask_size = np.asarray(mask_size, float)
        self.mask_size = mask_size * 1e3  # meters -> mm
        self.height = height
        self.frame = frame
        self.connections = connection
        self.simplify = simplify
        self.show_axis = show_axis
        self.model = None
        if generate:
            self.generate_3d_model()

    @classmethod
    def from_mask(cls, mask, **kwargs):
        """Build from a CodedAperture / FresnelZoneAperture mask object
        (fabrication.py:95-108)."""
        from .mask import CodedAperture, FresnelZoneAperture

        assert isinstance(mask, (CodedAperture, FresnelZoneAperture)), (
            "Mask must be a CodedAperture or FresnelZoneAperture object.")
        return cls(mask_array=_host(mask.mask), mask_size=_host(mask.size), **kwargs)

    @staticmethod
    def mask_to_points(mask: np.ndarray, px_size):
        """Mask cells -> 2-D coordinates (+ per-cell heights for graded
        masks) — pure geometry (fabrication.py:110-135).

        Binary masks extrude the OPAQUE (0 after the `mask==0` selection
        of transparent-coded arrays — i.e. value 0 marks material here,
        matching the reference) cells; masks with more than two levels
        extrude every nonzero cell at fractional height.
        """
        mask = np.asarray(mask)
        is_3D = len(np.unique(mask)) > 2
        if is_3D:
            indices = np.argwhere(mask != 0)
            coordinates = (indices - np.array(mask.shape) / 2) * np.asarray(px_size)
            heights = mask[indices[:, 0], indices[:, 1]]
        else:
            indices = np.argwhere(mask == 0)
            coordinates = (indices - np.array(mask.shape) / 2) * np.asarray(px_size)
            heights = None
        return coordinates, heights

    def generate_3d_model(self):
        assert self.model is None, "Model already generated."
        cq = _require_cadquery()
        model = cq.Workplane("XY")
        if self.frame is not None:
            model = model.add(self.frame.generate(self.mask_size, self.height))
        if self.connections is not None:
            model = model.add(
                self.connections.generate(self.mask, self.mask_size, self.height))

        px_size = self.mask_size / np.array(self.mask.shape)
        points, heights = Mask3DModel.mask_to_points(self.mask, px_size)
        if len(points) != 0:
            if heights is None:
                assert self.height is not None, "height must be provided if mask is 2D."
                mask_model = (
                    cq.Workplane("XY")
                    .pushPoints([tuple(p) for p in points])
                    .box(px_size[0], px_size[1], self.height,
                         centered=False, combine=False)
                )
            else:
                mask_model = cq.Workplane("XY")
                for point, height in zip(points, heights):
                    box = (
                        cq.Workplane("XY")
                        .moveTo(point[0], point[1])
                        .box(px_size[0], px_size[1], float(height) * self.height,
                             centered=False, combine=False)
                    )
                    mask_model = mask_model.add(box)
            if self.simplify:
                mask_model = mask_model.combine(glue=True)
            model = model.add(mask_model)
        if self.simplify:
            model = model.combine(glue=False)
        self.model = model
        return model

    def save(self, fname):
        assert self.model is not None, "Model not generated yet."
        cq = _require_cadquery()
        directory = os.path.dirname(fname)
        if directory and not os.path.exists(directory):
            print(f"Error: The directory {directory} does not exist! "
                  "Failed to save CadQuery model.")
            return
        cq.exporters.export(self.model, str(fname))
        return fname


class MultiLensMold:
    """Negative mold for casting a multi-lens array
    (fabrication.py:221-385): a base plate carrying the lens hemispheres
    plus a removal indent, subtracted from a mold block and flipped."""

    def __init__(self, sphere_locations, sphere_radius, mask_size,
                 mold_size=(0.4e-1, 0.4e-1, 3.0e-3), base_height_mm: float = 0.5,
                 frame=None, simplify: bool = False, show_axis: bool = False):
        self.sphere_locations = np.asarray(sphere_locations, float)
        self.sphere_radius = np.asarray(sphere_radius, float)
        self.mask_size_mm = np.asarray(mask_size, float) * 1e3
        self.mold_size_mm = np.array(mold_size, float) * 1e3
        self.base_height_mm = float(base_height_mm)
        self.frame = frame
        self.simplify = simplify
        self.show_axis = show_axis
        self.n_lens = len(self.sphere_radius)

        assert np.all(self.mask_size_mm <= self.mold_size_mm[:2]), (
            "Mold must be larger than mask.")
        assert self.base_height_mm < self.mold_size_mm[2], (
            "Base height must be less than mold height.")
        self.mask = None
        self.mold = None
        self._generate()

    def sphere_centers_mm(self):
        """Lens-sphere centers on the (origin-centered) base in mm —
        pure geometry."""
        locs = self.sphere_locations * 1e3
        centers = np.empty_like(locs)
        centers[:, 0] = locs[:, 0] - self.mask_size_mm[1] / 2
        centers[:, 1] = locs[:, 1] - self.mask_size_mm[0] / 2
        return centers

    def _generate(self):
        cq = _require_cadquery()
        model = cq.Workplane("XY")
        base_model = cq.Workplane("XY").box(
            self.mask_size_mm[0], self.mask_size_mm[1], self.base_height_mm,
            centered=(True, True, False))
        model = model.add(base_model)
        if self.frame is not None:
            model = model.add(
                self.frame.generate(self.mask_size_mm, self.base_height_mm))

        sphere_model = cq.Workplane("XY")
        for center, r in zip(self.sphere_centers_mm(), self.sphere_radius):
            sphere = (cq.Workplane("XY").moveTo(center[1], center[0])
                      .sphere(float(r) * 1e3, angle1=0))
            sphere_model = sphere_model.add(sphere)

        # removal indent at the frame/mask edge
        mask_dim = (self.frame.outline(self.mask_size_mm)[:2]
                    if self.frame is not None else self.mask_size_mm)
        indent = (
            cq.Workplane("XY")
            .moveTo(0, mask_dim[1] / 2)
            .box(self.base_height_mm, self.base_height_mm, self.base_height_mm)
        ).translate((0, 0, -self.base_height_mm / 2))
        sphere_model = sphere_model.add(indent)
        sphere_model = sphere_model.translate((0, 0, self.base_height_mm))
        model = model.add(sphere_model)
        if self.simplify:
            model = model.combine(glue=True)
        self.mask = model

        mold = cq.Workplane("XY").box(
            self.mold_size_mm[0], self.mold_size_mm[1], self.mold_size_mm[2],
            centered=(True, True, False))
        self.mold = mold.cut(model).rotate((0, 0, 0), (1, 0, 0), 180)
        return self.mold

    @classmethod
    def from_mask(cls, mask, **kwargs):
        """Build from a MultiLensArray mask object (fabrication.py:337-350)."""
        from .mask import MultiLensArray

        assert isinstance(mask, MultiLensArray), "Mask must be a MultiLensArray object."
        return cls(sphere_locations=_host(mask.loc), sphere_radius=_host(mask.radius),
                   mask_size=_host(mask.size), **kwargs)

    def save(self, fname):
        assert self.mold is not None, "Model not generated yet."
        cq = _require_cadquery()
        directory = os.path.dirname(fname)
        if directory and not os.path.exists(directory):
            print(f"Error: The directory {directory} does not exist! "
                  "Failed to save CadQuery model.")
            return
        cq.exporters.export(self.mold, str(fname))
        return fname


def adapter_dimensions_ok(mask_w, mask_h, adapter_w, adapter_h, support_w,
                          epsilon: float = 0.2):
    """Friction-fit feasibility checks for :func:`create_mask_adapter` —
    pure geometry, raises AssertionError on impossible dimensions."""
    assert mask_w < adapter_w - epsilon, "mask's width too big"
    assert mask_h < adapter_h - epsilon, "mask's height too big"
    assert mask_w - 2 * support_w > epsilon, "mask's support too big"
    return True


def create_mask_adapter(fp, mask_w, mask_h, mask_d, adapter_w=12.90,
                        adapter_h=9.90, support_w=0.4, support_d=0.4):
    """Adapter holding a mask in front of the sensor mount
    (fabrication.py:527+).  Friction-fitted parts should be made
    0.05-0.1 mm smaller than their slots.  All dimensions in mm."""
    adapter_dimensions_ok(mask_w, mask_h, adapter_w, adapter_h, support_w)
    cq = _require_cadquery()
    # outer shell with a through-window smaller than the mask by the
    # support lip, plus a recess of the mask's size and thickness
    outer = cq.Workplane("XY").box(adapter_w, adapter_h, support_d + mask_d,
                                   centered=(True, True, False))
    outer = (outer.faces(">Z").workplane()
             .rect(mask_w, mask_h).cutBlind(-mask_d))
    outer = (outer.faces("<Z").workplane()
             .rect(mask_w - 2 * support_w, mask_h - 2 * support_w)
             .cutThruAll())
    out_path = os.path.join(fp, "mask_adapter.stl") if os.path.isdir(fp) else fp
    cq.exporters.export(outer, str(out_path))
    return out_path
