"""SMPL renderer: a software rasterizer of the body mesh. The
linear-blend-skinned vertices of the body model (on the CPU), projected
through the AMASS ground truth's camera, are drawn as flat-shaded
triangles in painter's order (far to near) with cv2. Where the body model
has no mesh data, or no model file is there, it draws the SMPL skeleton's
points instead, so that video logging works everywhere. CPU only: cv2 is
imported where it draws."""
from typing import Iterable

import numpy as np
import torch

from ..skeletons.smpl import SMPL_SKELETON
from .points_renderer import PointsRenderer
from .renderer import Renderer

_LIGHT = np.asarray([0.3, -0.5, -0.8])
_LIGHT = _LIGHT / np.linalg.norm(_LIGHT)


class SMPLRenderer(Renderer):
    def __init__(self, body_model_dir: str = None, **kwargs):
        super().__init__(**kwargs)
        self._points = PointsRenderer(input_nodes=SMPL_SKELETON,
                                      image_size=self._image_size)
        self._body_model_dir = body_model_dir

    def _get_model(self, gender: str):
        """The body model of ``gender`` with its mesh, or None."""
        try:
            from ..data.smpl.body_model import get_body_model
            kwargs = {"body_model_dir": self._body_model_dir} \
                if self._body_model_dir else {}
            model = get_body_model(gender if gender in
                                   ("male", "female", "neutral")
                                   else "neutral", **kwargs)
            if model.skin_weights is not None and model.faces is not None:
                return model
        except Exception:
            pass
        return None

    def render(self, amass_body_pose=None, projection_2d=None, meta=None,
               **kwargs) -> Iterable[np.ndarray]:
        """One (L, H, W, 3) uint8 clip per clip: the mesh of each clip's
        ``amass_body_pose`` (its gender's model, from ``meta``), else the
        SMPL points of ``projection_2d``, else black frames."""
        genders = (meta or {}).get("gender")
        if amass_body_pose is not None:
            amass_body_pose = np.asarray(amass_body_pose)
            for i in range(len(amass_body_pose)):
                gender = str(genders[i]) if genders is not None else "neutral"
                model = self._get_model(gender)
                if model is not None:
                    yield self._render_mesh_clip(model, amass_body_pose[i])
                    continue
                yield self._fallback(projection_2d, i,
                                     amass_body_pose.shape[1])
            return
        if projection_2d is None:
            return
        for clip in np.asarray(projection_2d):
            yield self._points.render_clip(clip[..., :2])

    def _fallback(self, projection_2d, i, clip_length):
        if projection_2d is not None:
            return self._points.render_clip(
                np.asarray(projection_2d)[i][..., :2])
        return self.zeros(clip_length)

    # -- software rasterizer -------------------------------------------------
    def _render_mesh_clip(self, model, body_pose: np.ndarray) -> np.ndarray:
        """(L, >= (J-1)*3) axis-angle clip -> (L, H, W, 3) uint8 frames:
        its first (J-1)*3 values are the body pose."""
        import cv2

        from ..data.smpl.amass import CONVENTIONS_ROT, amass_camera
        from ..data.smpl.body_model import vertex_locations
        from ..ops import camera as C

        L = body_pose.shape[0]
        n_pose = (len(model.parents) - 1) * 3
        pose = np.zeros((L, n_pose), np.float32)
        n = min(n_pose, body_pose.reshape(L, -1).shape[1])
        pose[:, :n] = body_pose.reshape(L, -1)[:, :n]

        verts = vertex_locations(model, torch.from_numpy(pose)).numpy()
        verts = verts @ np.asarray(CONVENTIONS_ROT, np.float32)

        screen = C.project_pose(amass_camera(self._image_size),
                                torch.from_numpy(verts)).numpy()
        xy, depth = screen[..., :2], screen[..., 2]

        faces = np.asarray(model.faces, np.int64)
        w, h = self._image_size
        frames = np.zeros((L, h, w, 3), np.uint8)
        for t in range(L):
            frames[t] = self._rasterize(xy[t], depth[t], verts[t], faces,
                                        (h, w), cv2)
        return frames

    @staticmethod
    def _rasterize(xy, depth, verts, faces, hw, cv2):
        h, w = hw
        img = np.zeros((h, w, 3), np.uint8)
        tri = verts[faces]                                  # (F, 3, 3)
        normals = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        norm = np.linalg.norm(normals, axis=-1, keepdims=True)
        normals = normals / np.maximum(norm, 1e-9)
        shade = np.abs(normals @ _LIGHT)                    # two-sided
        color = (60 + 180 * shade).astype(np.uint8)

        face_depth = depth[faces].mean(-1)
        visible = face_depth > 1e-3                         # in front
        # numpy's default sort kind, as the JAX package's renderer: it
        # decides the order of faces of equal depth
        order = np.argsort(-face_depth)                     # far -> near
        order = order[visible[order]]
        pts = np.round(xy[faces]).astype(np.int32)          # (F, 3, 2)
        for f in order:
            c = int(color[f])
            cv2.fillConvexPoly(img, pts[f], (c, c, c), lineType=cv2.LINE_8)
        return img
