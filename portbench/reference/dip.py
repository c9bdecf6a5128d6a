r"""Plain reference of the DIP net (Deep Inertial Poser, Huang et al.,
SIGGRAPH Asia 2018, arXiv 1810.04703), as trikpachu/A3GC-IP trains and
evaluates it (``net_aagc.py:22-38`` ``DIP``, ``:1022-1031``
``PoseNetDIP``; ``evaluate_dip.py:88-124``).

The input drops the root sensor (the last 9 orientation and 3
acceleration channels), is normalized with the training stats of the
channels kept, and is the 60 features acc ‖ ori of the five other IMUs.
On those, x [B, T, 60]:

    x = ReLU(x W1 + b1)                                      [B, T, H]
    two stacked bidirectional LSTM layers (each with its own state), as in
    :mod:`portbench.reference.dense`: per direction, per frame,
        z = x_t W_ih + b_ih + b_hh + h W_hh                  [4H]
        c' = σ(f) c + σ(i) tanh(g);  h' = σ(o) tanh(c')
        the layer's output: h of both directions, concatenated
    y = x W2 + b2                                            [B, T, 135]

y is 15 global rotation matrices; inverse kinematics gives the local pose
of all 24 joints. Departures from ``net_aagc.py:22-38``: the dropout on
the input is off (inference), and IK is the reduced joints scattered into
an identity skeleton, local = parentᵀ · global, as the port computes it
(``reference.common.full_local_pose``).
"""

from __future__ import annotations

import torch

from portbench.reference import common as R
from portbench.reference.dense import _net, zero_state

ROOT_ORI, ROOT_ACC = 9, 3       # the root sensor's channels, last in each


def inputs(ori, acc, stats):
    r"""ori [..., 54], acc [..., 18] → [..., 60]: the root sensor dropped,
    (x − μ)/σ over the channels kept, accelerations first."""
    o = ((ori[..., :-ROOT_ORI] - stats["ori_mean_channel"][:-ROOT_ORI])
         / stats["ori_std_channel"][:-ROOT_ORI])
    a = ((acc[..., :-ROOT_ACC] - stats["acc_mean_channel"][:-ROOT_ACC])
         / stats["acc_std_channel"][:-ROOT_ACC])
    return R.flat_inputs(o, a)


@torch.no_grad()
def cascade(cfg, w, ori, acc, stats, n_valid, states=None, fmt="fp32"):
    r"""The DIP net on ori [B, T, 54], acc [B, T, 18] (frame t of stream b
    valid where t < n_valid[b]) → (local pose [B, T, 24, 3, 3], the final
    state of each LSTM layer). ``states`` None starts from zeros; ``fmt``
    is the products' operand format."""
    B, T = ori.shape[:2]
    if states is None:
        states = zero_state(cfg, B, ori.device)[0]
    out, state = _net(cfg, w, 1, inputs(ori, acc, stats), states, n_valid,
                      fmt)
    pose = R.full_local_pose(out.reshape(B * T, R.N_REDUCED, 3, 3))
    return pose.reshape(B, T, 24, 3, 3), state
