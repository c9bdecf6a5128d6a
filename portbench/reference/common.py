r"""What the plain references of every family share: the joint tables of the
15-node reduced skeleton, the IMU normalisation and layouts, inverse
kinematics, products with a chosen operand format, and the masked
bidirectional walk.

Plain PyTorch in fp32 (TF32 switched off while a reference runs), no
kernel, no cache. It imports nothing of the program: the tables below are
the published SMPL tree and the reduced skeleton of the A3GC / TransPose
training scripts.
"""

from __future__ import annotations

import contextlib

import torch

# SMPL's kinematic tree
PARENT = (None, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9,
          12, 13, 14, 16, 17, 18, 19, 20, 21)
REDUCED = (1, 2, 3, 4, 5, 6, 9, 12, 13, 14, 15, 16, 17, 18, 19)
IGNORED = (0, 7, 8, 10, 11, 20, 21, 22, 23)
INPUT_NODES = (3, 4, 13, 14, 10)    # reduced nodes of the 5 non-root IMUs
N_REDUCED = 15

FORMATS = ("fp32", "bf16")


@contextlib.contextmanager
def no_tf32():
    r"""fp32 products really in fp32 on the card for the block."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


def rnd(t: torch.Tensor, fmt: str) -> torch.Tensor:
    r"""``t`` as a product's operand: itself in "fp32", rounded to bfloat16
    in "bf16" (the control one precision below TF32)."""
    if fmt == "fp32":
        return t
    if fmt != "bf16":
        raise ValueError(f"operand format {fmt!r} not in {FORMATS}")
    return t.to(torch.bfloat16).to(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, fmt: str) -> torch.Tensor:
    r"""``a @ b`` on operands in format ``fmt``, summed in fp32."""
    return torch.matmul(rnd(a, fmt), rnd(b, fmt))


def normalize(ori, acc, stats):
    r"""Per-channel (x − μ)/σ with the training stats."""
    return ((ori - stats["ori_mean_channel"]) / stats["ori_std_channel"],
            (acc - stats["acc_mean_channel"]) / stats["acc_std_channel"])


def graph_inputs(ori, acc):
    r"""ori [..., 54], acc [..., 18] → [..., 15, 12]: the acceleration and
    the orientation of each non-root IMU on its node, zeros elsewhere."""
    lead = ori.shape[:-1]
    feats = torch.cat((acc.reshape(lead + (6, 3))[..., :5, :],
                       ori.reshape(lead + (6, 9))[..., :5, :]), dim=-1)
    out = ori.new_zeros(lead + (N_REDUCED, 12))
    out[..., list(INPUT_NODES), :] = feats
    return out


def flat_inputs(ori, acc):
    r"""ori [..., 54], acc [..., 18] → [..., 72], accelerations first."""
    return torch.cat((acc, ori), dim=-1)


def full_local_pose(glb: torch.Tensor) -> torch.Tensor:
    r"""15 global rotations [F, 15, 3, 3] of the reduced joints → the local
    pose of all 24 joints [F, 24, 3, 3]: the reduced joints scattered into
    an identity skeleton, local = parentᵀ · global (the root keeps its
    global rotation), the ignored joints set to the identity."""
    F = glb.shape[0]
    eye = torch.eye(3, dtype=glb.dtype, device=glb.device)
    full = eye.expand(F, 24, 3, 3).clone()
    full[:, list(REDUCED)] = glb
    local = full.clone()
    for j, p in enumerate(PARENT):
        if p is not None:
            local[:, j] = full[:, p].transpose(-1, -2) @ full[:, j]
    local[:, list(IGNORED)] = eye
    return local


def walk(step, seq2: torch.Tensor, state, n_valid: torch.Tensor):
    r"""The masked bidirectional walk over inputs already in walk order.

    ``seq2`` [2, T, B, ...]: direction 0's frames 0 … T-1 and direction 1's
    frames T-1 … 0; ``state`` a tuple of [2, B, ...] tensors; frame t of
    stream b is valid where t < n_valid[b] (in direction 1 the padding
    comes first). ``step(u_t, state) -> state``; a step of an invalid frame
    leaves the state as it was. Returns (the carried first state leaf after
    each step [2, T, B, ...], the final state)."""
    T = seq2.shape[1]
    t = torch.arange(T, device=seq2.device)
    valid = t[:, None] < n_valid[None, :]                      # [T, B]
    masks = torch.stack((valid, valid.flip(0)), dim=1)          # [T, 2, B]
    outs = []
    for i in range(T):
        new = step(seq2[:, i], state)
        m = masks[i]
        state = tuple(torch.where(m.reshape(m.shape + (1,) * (a.dim() - 2)),
                                  a, b) for a, b in zip(new, state))
        outs.append(state[0])
    return torch.stack(outs, dim=1), state


def in_walk_order(u: torch.Tensor) -> torch.Tensor:
    r"""[2, B, T, ...] in frame order → [2, T, B, ...] in each direction's
    walk order."""
    ut = u.transpose(1, 2)
    return torch.stack((ut[0], ut[1].flip(0)))


def in_frame_order(hs: torch.Tensor) -> torch.Tensor:
    r"""[2, T, B, ..., H] in walk order → [B, T, ..., 2H], forward ‖
    backward in frame order."""
    return torch.cat((hs[0], hs[1].flip(0)), dim=-1).transpose(0, 1)
