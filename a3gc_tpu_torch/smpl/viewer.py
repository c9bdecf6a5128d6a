r"""Headless motion visualization (counterpart of
``a3gc_tpu/smpl/viewer.py``): skeletons and skinned meshes rasterized by a
small orthographic software renderer (Pillow, imported when a function is
called) into frames, written as an animated GIF or a PNG. Host numpy: the
callers copy their joints or vertices off the device once.

Conventions: SMPL is y-up; the camera looks down -z (front view) with an
orthographic projection. Several subjects are laid out side by side along
x.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["render_skeleton", "render_mesh", "save_animation"]


def _fit_transform(points: np.ndarray, size: int, margin: float = 0.08):
    """Map world xy onto pixel coordinates preserving aspect (y flipped)."""
    lo = points.reshape(-1, 3).min(axis=0)
    hi = points.reshape(-1, 3).max(axis=0)
    span = float(max(hi[0] - lo[0], hi[1] - lo[1], 1e-6))
    scale = size * (1.0 - 2 * margin) / span
    cx, cy = (lo[0] + hi[0]) / 2, (lo[1] + hi[1]) / 2

    def to_px(p):
        x = (p[..., 0] - cx) * scale + size / 2
        y = size / 2 - (p[..., 1] - cy) * scale
        return np.stack((x, y), axis=-1)

    return to_px


def render_skeleton(joints, parent: Sequence[Optional[int]], size: int = 360,
                    colors: Optional[Sequence[Tuple[int, int, int]]] = None
                    ) -> np.ndarray:
    r"""Rasterize joint skeletons: bones as segments, joints as dots.

    :param joints: [T, J, 3] or a list of [T, J, 3] (one per subject,
        already offset along x by the caller).
    :return: uint8 frames [T, size, size, 3].
    """
    from PIL import Image, ImageDraw

    subjects = [np.asarray(j, np.float64) for j in
                (joints if isinstance(joints, (list, tuple)) else [joints])]
    T = subjects[0].shape[0]
    allpts = np.concatenate([s.reshape(T, -1, 3) for s in subjects], axis=1)
    to_px = _fit_transform(allpts, size)
    if colors is None:
        colors = [(31, 119, 180), (214, 39, 40), (44, 160, 44),
                  (148, 103, 189)]

    frames = np.empty((T, size, size, 3), np.uint8)
    for t in range(T):
        im = Image.new("RGB", (size, size), (255, 255, 255))
        draw = ImageDraw.Draw(im)
        for si, s in enumerate(subjects):
            col = colors[si % len(colors)]
            px = to_px(s[t])
            for j, p in enumerate(parent):
                if p is None or p < 0:
                    continue
                draw.line((px[j, 0], px[j, 1], px[p, 0], px[p, 1]),
                          fill=col, width=2)
            r = max(size // 180, 2)
            for j in range(px.shape[0]):
                draw.ellipse((px[j, 0] - r, px[j, 1] - r,
                              px[j, 0] + r, px[j, 1] + r), fill=col)
        frames[t] = np.asarray(im)
    return frames


def render_mesh(vertices, faces, size: int = 360,
                light=(0.3, 0.6, 0.74)) -> np.ndarray:
    r"""Rasterize triangle meshes: painter's-algorithm depth sort + flat
    Lambert shading (orthographic front view).

    :param vertices: [T, V, 3] or a list of [T, V, 3] (one per subject).
    :param faces: [F, 3] int vertex indices (per subject; offsets applied
        internally when several subjects share the template topology).
    :return: uint8 frames [T, size, size, 3].
    """
    from PIL import Image, ImageDraw

    subjects = [np.asarray(v, np.float64) for v in
                (vertices if isinstance(vertices, (list, tuple))
                 else [vertices])]
    T = subjects[0].shape[0]
    verts = np.concatenate(subjects, axis=1)              # [T, S·V, 3]
    f = np.asarray(faces, np.int64)
    fs = np.concatenate([f + i * subjects[0].shape[1]
                         for i in range(len(subjects))])  # [S·F, 3]
    to_px = _fit_transform(verts, size)
    light = np.asarray(light) / np.linalg.norm(light)

    frames = np.empty((T, size, size, 3), np.uint8)
    for t in range(T):
        tri = verts[t][fs]                                # [F, 3, 3]
        # flat normals + Lambert intensity
        n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        n /= np.linalg.norm(n, axis=-1, keepdims=True) + 1e-12
        inten = np.clip(n @ light, 0.0, 1.0) * 0.75 + 0.25
        # painter's algorithm: draw far (small z) first; camera looks -z
        order = np.argsort(tri[:, :, 2].mean(axis=1))
        px = to_px(tri)                                   # [F, 3, 2]
        im = Image.new("RGB", (size, size), (255, 255, 255))
        draw = ImageDraw.Draw(im)
        base = np.asarray((120, 144, 190), np.float64)
        for i in order:
            c = tuple((base * inten[i]).astype(np.uint8))
            draw.polygon([tuple(p) for p in px[i]], fill=c)
        frames[t] = np.asarray(im)
    return frames


def save_animation(frames: np.ndarray, path: str, fps: int = 60) -> str:
    r"""Write uint8 frames [T, H, W, 3] as an animated GIF (T > 1) or a
    single PNG. Returns the path written."""
    from PIL import Image

    frames = np.asarray(frames)
    images = [Image.fromarray(f) for f in frames]
    if len(images) == 1 or path.endswith(".png"):
        images[0].save(path)
        return path
    images[0].save(path, save_all=True, append_images=images[1:],
                   duration=max(int(round(1000.0 / fps)), 20), loop=0)
    return path
