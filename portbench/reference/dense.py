r"""Plain reference of the TransPose cascade (Yi et al., SIGGRAPH 2021,
as trained by trikpachu/A3GC-IP ``train_tp.py``).

Per stage (a DIP net), on flat features x [B, T, F]:

    x = ReLU(x W1 + b1)
    for each of the stacked bidirectional LSTM layers (each with its own
    state): per direction, per frame (direction 1 walks backwards),
        z = x_t W_ih + b_ih + b_hh + h W_hh                [4H]
        c' = σ(f) c + σ(i) tanh(g);  h' = σ(o) tanh(c')
        the layer's output: h of both directions, concatenated
    y = x W2 + b2

Stage 1 maps the 72 IMU features to 15 leaf coordinates, stage 2 the IMU
and those to 69 joint coordinates, stage 3 the IMU and those to the 15
global rotations; inverse kinematics gives the local pose. Streams carry
their states across windows; frames past ``n_valid`` leave them as they
were.
"""

from __future__ import annotations

import torch

from portbench.reference import common as R


def _layer(w, p, x, state, n_valid, fmt):
    w_ih, w_hh = w[p + "w_ih"], w[p + "w_hh"]       # [2, F, 4H], [2, H, 4H]
    B, T, F = x.shape
    H = w_hh.shape[-2]
    u = R.mm(x.reshape(1, B * T, F), w_ih, fmt) \
        + (w[p + "b_ih"] + w[p + "b_hh"])[:, None]
    seq2 = R.in_walk_order(u.reshape(2, B, T, 4 * H))

    def step(u_t, st):
        h, c = st
        z = u_t + R.mm(h, w_hh, fmt)
        c = torch.sigmoid(z[..., H:2 * H]) * c \
            + torch.sigmoid(z[..., :H]) * torch.tanh(z[..., 2 * H:3 * H])
        return torch.sigmoid(z[..., 3 * H:]) * torch.tanh(c), c

    hs, state = R.walk(step, seq2, state, n_valid)
    return R.in_frame_order(hs), state


def zero_state(cfg, B, device):
    return tuple(
        tuple(tuple(torch.zeros(2, B, st["n_hidden"], device=device)
                    for _ in range(2))
              for _ in range(cfg["layers"]))
        for st in cfg["stages"])


def _net(cfg, w, s, x, state, n_valid, fmt):
    p = f"s{s}."
    x = torch.relu(R.mm(x, w[p + "linear1.kernel"], fmt)
                   + w[p + "linear1.bias"])
    new = []
    for i, st in enumerate(state):
        x, st = _layer(w, f"{p}lstm.{i}.", x, st, n_valid, fmt)
        new.append(st)
    return R.mm(x, w[p + "linear2.kernel"], fmt) + w[p + "linear2.bias"], \
        tuple(new)


@torch.no_grad()
def cascade(cfg, w, ori, acc, stats, n_valid, states=None, fmt="fp32"):
    r"""As :func:`portbench.reference.graph.cascade`, for the TransPose
    cascade."""
    B, T = ori.shape[:2]
    if states is None:
        states = zero_state(cfg, B, ori.device)
    o, a = R.normalize(ori, acc, stats)
    imu = R.flat_inputs(o, a)                                   # [B, T, 72]
    leaf, s1 = _net(cfg, w, 1, imu, states[0], n_valid, fmt)
    full, s2 = _net(cfg, w, 2, torch.cat((imu, leaf), dim=-1), states[1],
                    n_valid, fmt)
    out, s3 = _net(cfg, w, 3, torch.cat((imu, full), dim=-1), states[2],
                   n_valid, fmt)
    pose = R.full_local_pose(out.reshape(B * T, R.N_REDUCED, 3, 3))
    return pose.reshape(B, T, 24, 3, 3), (s1, s2, s3)
