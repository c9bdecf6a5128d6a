r"""Deterministic synthetic SMPL-like body model (a copy of
``a3gc_tpu/smpl/synthetic.py``: the same seed gives the same arrays, bit for
bit).

The official SMPL pickles do not ship with the repository. To keep the
tests, the smoke run and the command line runnable without them, this
module generates a structurally identical body model: the 24-joint SMPL
kinematic tree and a plausible rest skeleton, a configurable number of mesh
vertices placed along the bones, distance-based skinning weights (each
vertex blends its four nearest joints), a consistent J_regressor, and small
random shapedirs / posedirs. ``write_synthetic_smpl_pickle`` writes it in
the official pickle schema (same keys and dtypes, a scipy-sparse
J_regressor), so both packages load the same file.
"""

from __future__ import annotations

import pickle
from typing import Dict

import numpy as np

from a3gc_tpu_torch.smpl.armature import SMPL_PARENT

__all__ = ["synthetic_smpl_data", "write_synthetic_smpl_pickle"]

# plausible SMPL-ish rest joint positions (meters, y-up, T-pose)
_REST_JOINTS = np.array([
    [+0.000, +0.940, +0.000],   # 0  pelvis
    [+0.070, +0.870, +0.010],   # 1  L hip
    [-0.070, +0.870, +0.010],   # 2  R hip
    [+0.000, +1.050, -0.010],   # 3  spine1
    [+0.100, +0.490, +0.010],   # 4  L knee
    [-0.100, +0.490, +0.010],   # 5  R knee
    [+0.000, +1.180, -0.010],   # 6  spine2
    [+0.090, +0.090, -0.020],   # 7  L ankle
    [-0.090, +0.090, -0.020],   # 8  R ankle
    [+0.000, +1.290, +0.000],   # 9  spine3
    [+0.110, +0.020, +0.100],   # 10 L foot
    [-0.110, +0.020, +0.100],   # 11 R foot
    [+0.000, +1.450, -0.020],   # 12 neck
    [+0.080, +1.380, -0.010],   # 13 L clavicle
    [-0.080, +1.380, -0.010],   # 14 R clavicle
    [+0.000, +1.550, +0.010],   # 15 head
    [+0.180, +1.400, -0.010],   # 16 L shoulder
    [-0.180, +1.400, -0.010],   # 17 R shoulder
    [+0.440, +1.400, -0.020],   # 18 L elbow
    [-0.440, +1.400, -0.020],   # 19 R elbow
    [+0.700, +1.400, -0.020],   # 20 L wrist
    [-0.700, +1.400, -0.020],   # 21 R wrist
    [+0.780, +1.390, -0.010],   # 22 L hand
    [-0.780, +1.390, -0.010],   # 23 R hand
], dtype=np.float64)


def synthetic_smpl_data(n_vertices: int = 432, n_shapes: int = 10,
                        seed: int = 0) -> Dict[str, np.ndarray]:
    r"""Build the raw arrays of a synthetic SMPL-compatible model.

    Returns a dict with the official pickle's keys:
    J_regressor [24,V] (dense here), weights [V,24], posedirs [V,3,207],
    shapedirs [V,3,n_shapes], v_template [V,3], J [24,3], f [F,3],
    kintree_table [2,24].
    """
    rng = np.random.default_rng(seed)
    J = _REST_JOINTS.copy()
    n_joints = J.shape[0]
    parent = np.array([p if p is not None else 0 for p in SMPL_PARENT])

    # vertices: scatter along each bone segment with radial offset so the
    # cloud looks like a body and every joint owns some vertices.
    per_bone = n_vertices // (n_joints - 1)
    extra = n_vertices - per_bone * (n_joints - 1)
    verts = []
    owner = []
    for j in range(1, n_joints):
        k = per_bone + (extra if j == n_joints - 1 else 0)
        t = rng.uniform(0.0, 1.0, size=(k, 1))
        base = J[parent[j]] * (1 - t) + J[j] * t
        offset = rng.normal(scale=0.04, size=(k, 3))
        verts.append(base + offset)
        owner.append(np.full(k, j))
    v_template = np.concatenate(verts, axis=0)
    owner = np.concatenate(owner)
    V = v_template.shape[0]

    # smooth skinning weights: softmax over negative distance to the 24 joints
    d = np.linalg.norm(v_template[:, None, :] - J[None, :, :], axis=-1)
    logits = -d / 0.08
    logits = logits - logits.max(axis=1, keepdims=True)
    w = np.exp(logits)
    # keep only the 4 nearest joints per vertex (like real SMPL)
    order = np.argsort(-w, axis=1)
    mask = np.zeros_like(w)
    np.put_along_axis(mask, order[:, :4], 1.0, axis=1)
    w = w * mask
    weights = w / w.sum(axis=1, keepdims=True)

    # J_regressor: average of each joint's owned vertices, with a fallback to
    # nearest vertices for joints that own none (joint 0).
    j_regressor = np.zeros((n_joints, V))
    for j in range(n_joints):
        idx = np.where(owner == j)[0]
        if idx.size == 0:
            idx = np.argsort(d[:, j])[:8]
        j_regressor[j, idx] = 1.0 / idx.size
    # small random blendshapes
    shapedirs = rng.normal(scale=0.01, size=(V, 3, n_shapes))
    posedirs = rng.normal(scale=0.001, size=(V, 3, 9 * (n_joints - 1)))

    # faces: consecutive triples (topology is irrelevant for compute tests)
    n_faces = max(V - 2, 1)
    f = np.stack([np.arange(n_faces),
                  (np.arange(n_faces) + 1) % V,
                  (np.arange(n_faces) + 2) % V], axis=1).astype(np.int32)

    # official files mark the root's parent as uint32(-1) = 4294967295
    kintree = np.stack([
        np.array([4294967295] + parent[1:].tolist(), dtype=np.int64),
        np.arange(n_joints, dtype=np.int64)])

    return {
        "J_regressor": j_regressor,
        "weights": weights,
        "posedirs": posedirs,
        "shapedirs": shapedirs,
        "v_template": v_template,
        "J": J,
        "f": f,
        "kintree_table": kintree,
    }


def write_synthetic_smpl_pickle(path: str, n_vertices: int = 432,
                                seed: int = 0) -> str:
    r"""Serialize the synthetic model in the official SMPL pickle schema
    (scipy-sparse J_regressor), so every loader of that schema reads it."""
    import scipy.sparse as sp

    data = synthetic_smpl_data(n_vertices=n_vertices, seed=seed)
    data = dict(data)
    data["J_regressor"] = sp.csc_matrix(data["J_regressor"])
    with open(path, "wb") as fh:
        pickle.dump(data, fh)
    return path
