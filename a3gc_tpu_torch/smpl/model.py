r"""SMPL / MANO / SMPLH parametric body model (counterpart of
``a3gc_tpu/smpl/model.py``): the official pickle loaded once into fp32
tensors on the model's device; forward kinematics with linear blend skinning
and pose blendshapes, inverse kinematics, the zero pose, the host-side
exports and the motion viewers.

``ParametricModel()`` with no arrays holds only the SMPL kinematic tree:
enough for inverse kinematics, which is all the serving sessions need.
Forward kinematics and skinning need a model from
:func:`load_parametric_model` (or one built from the arrays)."""

from __future__ import annotations

import copy
import os
import pickle
from typing import Optional, Sequence

import numpy as np
import torch

from a3gc_tpu_torch._device import resolve_device
from a3gc_tpu_torch.ops import kinematics as K
from a3gc_tpu_torch.ops import rotations as R
from a3gc_tpu_torch.smpl.armature import SMPL_PARENT

__all__ = ["SMPL_PARENT", "ParametricModel", "load_parametric_model"]

_ARRAYS = ("j_regressor", "skinning_weights", "posedirs", "shapedirs",
           "v_template", "joints_template")


class ParametricModel:
    r"""A body model: its kinematic tree ``parent`` and, when loaded, its
    arrays as fp32 tensors on ``device``: ``j_regressor`` [J, V],
    ``skinning_weights`` [V, J], ``posedirs`` [V, 3, 9·(J-1)],
    ``shapedirs`` [V, 3, n_shape], ``v_template`` [V, 3], ``joints_template``
    [J, 3] (the pickle's ``J``); ``faces`` [F, 3] stays a numpy array.
    Methods take numpy arrays or tensors and compute on the model's device
    (the tree-only methods on the input's)."""

    def __init__(self, parent: Sequence[Optional[int]] = SMPL_PARENT, *,
                 j_regressor=None, skinning_weights=None, posedirs=None,
                 shapedirs=None, v_template=None, joints_template=None,
                 faces=None, use_pose_blendshape: bool = False,
                 device="cuda"):
        self.parent = tuple(parent)
        arrays = dict(j_regressor=j_regressor,
                      skinning_weights=skinning_weights, posedirs=posedirs,
                      shapedirs=shapedirs, v_template=v_template,
                      joints_template=joints_template)
        given = [k for k, v in arrays.items() if v is not None]
        if given and len(given) != len(arrays):
            raise ValueError("a body model needs all of "
                             f"{', '.join(_ARRAYS)} or none; got "
                             f"{', '.join(given)}")
        self.device = resolve_device(device) if given else None
        self._dtype = torch.float32
        for k, v in arrays.items():
            setattr(self, k, None if v is None else torch.as_tensor(
                v, dtype=torch.float32, device=self.device))
        self.faces = None if faces is None else np.asarray(faces)
        self.use_pose_blendshape = bool(use_pose_blendshape)

    @property
    def n_joints(self) -> int:
        return len(self.parent)

    @property
    def n_vertices(self) -> int:
        self._need_arrays()
        return self.v_template.shape[0]

    def _need_arrays(self):
        if self.v_template is None:
            raise ValueError(
                "this body model holds only the kinematic tree; forward "
                "kinematics, skinning and the zero pose need the arrays of "
                "an SMPL file: load one with load_parametric_model")

    def as_tensor(self, x) -> torch.Tensor:
        r"""``x`` as a tensor of the model's dtype (fp32 but in a copy made
        by :meth:`_astype`) on the model's device (a tree-only model: where
        ``x`` lies, numpy on the CPU)."""
        return torch.as_tensor(x, dtype=self._dtype, device=self.device)

    def _astype(self, dtype: torch.dtype) -> "ParametricModel":
        r"""A copy of this model that computes in ``dtype``: its arrays
        cast, on the same device."""
        out = copy.copy(self)
        out._dtype = dtype
        for k in _ARRAYS:
            v = getattr(self, k)
            setattr(out, k, None if v is None else v.to(dtype))
        return out

    # ------------------------------------------------------------------
    # zero pose
    # ------------------------------------------------------------------
    def get_zero_pose_joint_and_vertex(self, shape=None):
        r"""Joint and vertex positions in the zero pose, the root at the
        origin. shape=None → the mean shape, ([J, 3], [V, 3]); shape
        [B, n_shape] → ([B, J, 3], [B, V, 3])."""
        self._need_arrays()
        if shape is None:
            j = self.joints_template - self.joints_template[:1]
            v = self.v_template - self.joints_template[:1]
            return j, v
        shape = self.as_tensor(shape).reshape(-1, self.shapedirs.shape[-1])
        v = torch.einsum("bs,vxs->bvx", shape, self.shapedirs) \
            + self.v_template
        j = torch.einsum("jv,bvx->bjx", self.j_regressor, v)
        return j - j[:, :1], v - j[:, :1]

    # ------------------------------------------------------------------
    # tree ops bound to this skeleton
    # ------------------------------------------------------------------
    def bone_vector_to_joint_position(self, bone_vec):
        return K.bone_vector_to_joint_position(bone_vec, self.parent)

    def joint_position_to_bone_vector(self, joint_pos):
        return K.joint_position_to_bone_vector(joint_pos, self.parent)

    def forward_kinematics_R(self, R_local):
        return K.forward_kinematics_R(R_local, self.parent)

    def inverse_kinematics_R(self, R_global):
        return K.inverse_kinematics_R(R_global, self.parent)

    def forward_kinematics_T(self, T_local):
        return K.forward_kinematics_T(T_local, self.parent)

    def inverse_kinematics_T(self, T_global):
        return K.inverse_kinematics_T(T_global, self.parent)

    # ------------------------------------------------------------------
    # full FK + linear blend skinning
    # ------------------------------------------------------------------
    def forward_kinematics(self, pose, shape=None, tran=None,
                           calc_mesh: bool = False):
        r"""Global joint rotations and positions (and the mesh vertices).

        :param pose: local rotations, reshapable to [B, J, 3, 3].
        :param shape: [B, n_shape] betas (one row expands to the batch), or
            None for the mean shape.
        :param tran: [B, 3] root translation or None.
        :return: (R_global [B, J, 3, 3], p_global [B, J, 3][, vertices
            [B, V, 3]])."""
        self._need_arrays()
        pose = self.as_tensor(pose)
        B = pose.shape[0]
        pose = pose.reshape(B, -1, 3, 3)
        j, v = self.get_zero_pose_joint_and_vertex(shape)
        if shape is None:
            j, v = j[None], v[None]
        j = j.expand((B,) + j.shape[1:])
        v = v.expand((B,) + v.shape[1:])
        bone_vec = self.joint_position_to_bone_vector(j)
        R_global, p_global = K.forward_kinematics(pose, bone_vec, self.parent)

        def add_tran(x):
            if tran is None:
                return x
            return x + self.as_tensor(tran).reshape(-1, 1, 3)

        if not calc_mesh:
            return R_global, add_tran(p_global)

        # LBS: each joint's global transform relative to its rest position,
        # blended per vertex: v' = (Σ_j w[v,j] R_j) v + Σ_j w[v,j] t_j
        if self.use_pose_blendshape:
            eye = torch.eye(3, dtype=pose.dtype, device=pose.device)
            r = (pose[:, 1:] - eye).reshape(B, -1)
            v = v + torch.einsum("bp,vxp->bvx", r, self.posedirs)
        # the translation of joint j's skinning transform
        t = p_global - torch.matmul(R_global, j[..., None])[..., 0]
        Rv = torch.einsum("vj,bjxy->bvxy", self.skinning_weights, R_global)
        tv = torch.einsum("vj,bjx->bvx", self.skinning_weights, t)
        vertex_global = (Rv * v[:, :, None, :]).sum(-1) + tv
        return R_global, add_tran(p_global), add_tran(vertex_global)

    def forward_kinematics_batch(self, pose, shape=None, tran=None,
                                 calc_mesh: bool = False, batch_size=None):
        r"""Alias of :meth:`forward_kinematics` (the reference chunks into
        host batches; one call here)."""
        del batch_size
        return self.forward_kinematics(pose, shape, tran, calc_mesh)

    # ------------------------------------------------------------------
    # host-side exports
    # ------------------------------------------------------------------
    def save_obj_mesh(self, vertex_position, file_name="a.obj"):
        r"""Write an obj mesh from [V, 3] vertex positions."""
        verts = np.asarray(torch.as_tensor(vertex_position).cpu()).reshape(
            -1, 3)
        with open(file_name, "w") as fp:
            for v in verts:
                fp.write("v %f %f %f\n" % (v[0], v[1], v[2]))
            if self.faces is not None:
                for f in self.faces + 1:
                    fp.write("f %d %d %d\n" % (f[0], f[1], f[2]))

    @staticmethod
    def save_unity_motion(pose=None, tran=None, output_dir="saved_motions/"):
        r"""Write motions into Unity3D ``LoadMotion()`` text files: pose as
        axis-angle per joint, translation per frame."""
        os.makedirs(output_dir, exist_ok=True)
        if pose is not None:
            pose = torch.as_tensor(pose, dtype=torch.float32)
            n = pose.shape[0]
            aa = R.rotation_matrix_to_axis_angle(pose).reshape(n, -1)
            with open(os.path.join(output_dir, "pose.txt"), "w") as f:
                f.write("\n".join(
                    [",".join(["%.4f" % _ for _ in p])
                     for p in aa.cpu().numpy()]))
        if tran is not None:
            tran = np.asarray(torch.as_tensor(tran).cpu()).reshape(-1, 3)
            with open(os.path.join(output_dir, "tran.txt"), "w") as f:
                f.write("\n".join(
                    [",".join(["%.5f" % _ for _ in t]) for t in tran]))

    # ------------------------------------------------------------------
    # motion viewers: the headless rasterizer of smpl/viewer.py writes an
    # animated GIF or a PNG
    # ------------------------------------------------------------------
    def view_joint(self, joint_list, fps=60, distance_between_subjects=0.8,
                   out_path="motion_joints.gif", size=360):
        r"""Render joint skeletons ([T, J, 3] each, numpy or tensors) side
        by side, each moved so that its first frame's root is at the
        origin. Returns the written path."""
        from a3gc_tpu_torch.smpl.viewer import render_skeleton, save_animation

        J = self.n_joints
        subjects = []
        for i, j in enumerate(joint_list):
            j = _host(j).reshape(-1, J, 3)
            j = j - j[:1, :1]
            j[:, :, 0] += distance_between_subjects * i
            subjects.append(j)
        frames = render_skeleton(subjects, self.parent, size=size)
        return save_animation(frames, out_path, fps=fps)

    def view_mesh(self, vertex_list, fps=60, distance_between_subjects=0.8,
                  out_path="motion_mesh.gif", size=360):
        r"""Render skinned meshes ([T, V, 3] each) side by side. Returns the
        written path."""
        from a3gc_tpu_torch.smpl.viewer import render_mesh, save_animation

        subjects = []
        for i, v in enumerate(vertex_list):
            v = _host(v).reshape(-1, self.n_vertices, 3)
            v[:, :, 0] += distance_between_subjects * i
            subjects.append(v)
        frames = render_mesh(subjects, np.asarray(self.faces), size=size)
        return save_animation(frames, out_path, fps=fps)

    def view_motion(self, pose_list, tran_list=None, fps=60,
                    distance_between_subjects=0.8,
                    out_path="motion.gif", size=360):
        r"""FK + skinning of each local pose sequence ([T, J, 3, 3]; its
        translation relative to its first frame) on the model's device, one
        host copy of each mesh, then :meth:`view_mesh`."""
        verts = []
        for i, pose in enumerate(pose_list):
            pose = self.as_tensor(pose).reshape(-1, self.n_joints, 3, 3)
            tran = None
            if tran_list is not None:
                t = self.as_tensor(tran_list[i]).reshape(-1, 3)
                tran = t - t[:1]
            verts.append(self.forward_kinematics(
                pose, tran=tran, calc_mesh=True)[2].cpu().numpy())
        return self.view_mesh(
            verts, fps, distance_between_subjects=distance_between_subjects,
            out_path=out_path, size=size)


def _host(x) -> np.ndarray:
    r"""A numpy copy of an array or a tensor on any device."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy().copy()
    return np.array(x)


def load_parametric_model(official_model_file: str,
                          use_pose_blendshape: bool = False,
                          device="cuda") -> ParametricModel:
    r"""Load an official SMPL/MANO/SMPLH pickle (the J_regressor may be
    scipy-sparse) into a :class:`ParametricModel` on ``device``."""
    with open(official_model_file, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    jreg = data["J_regressor"]
    if hasattr(jreg, "toarray"):
        jreg = jreg.toarray()
    parent = list(data["kintree_table"][0].tolist())
    parent[0] = None
    return ParametricModel(
        parent, j_regressor=jreg, skinning_weights=data["weights"],
        posedirs=data["posedirs"], shapedirs=data["shapedirs"],
        v_template=data["v_template"], joints_template=data["J"],
        faces=data["f"], use_pose_blendshape=use_pose_blendshape,
        device=device)
