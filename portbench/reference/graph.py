r"""Plain reference of the graph-LSTM cascade (A3GC-TP, arXiv 2107.11214).

Per stage, on node features x [B, T, N, F]:

    x  = ReLU(A_in · (x W_in) + b_in)                      (AAGC projection)
    for layer in (rnn1, rnn2), one state (h, c) threaded through both:
        per direction, per frame (direction 1 walks the frames backwards):
        z  = x_t W_x + h W_h                               [N, 4H]
        g  = A_k · z_k + b_k  for each gate k of i, f, g, o
        c' = σ(f) c + σ(i) tanh(g);  h' = σ(o) tanh(c')
        attention (a3gc / agc):
            q = ReLU(Σ_nodes h' W);  s = tanh(h' Wh + q Wq + bs)
            h' = h' + h' σ(s u + bu)
        the layer's output: tanh(h) of both directions, concatenated
    y  = A_out · (x W_out) + b_out

Stage 1 maps the IMU nodes to leaf positions, stage 2 the IMU nodes and
those to all positions, stage 3 the IMU nodes and those to the 15 global
rotations; inverse kinematics gives the local pose. A window of a stream
starts from the state that the previous window of the stream left; frames
past a stream's ``n_valid`` leave its state as it was.
"""

from __future__ import annotations

import torch

from portbench.reference import common as R


def _conv(w, p, x, fmt):
    return R.mm(w[p + "adj"], R.mm(x, w[p + "kernel"], fmt), fmt) \
        + w[p + "bias"]


def _layer(w, p, x, state, n_valid, attention, fmt):
    kernel = w[p + "kernel"]                        # [2, F+H, 4H]
    B, T, N, F = x.shape
    H = kernel.shape[-1] // 4
    u = R.mm(x.reshape(1, B * T * N, F), kernel[:, :F], fmt)
    seq2 = R.in_walk_order(u.reshape(2, B, T, N, 4 * H))
    wh = kernel[:, F:][:, None]                     # [2, 1, H, 4H]
    adj, bias = w[p + "adj"], w[p + "bias"][:, None, None]
    if attention:
        aw, awq, awh, au = (w[p + "attention." + k][:, None]
                            for k in ("w", "wq", "wh", "u"))
        bs = w[p + "attention.bs"][:, None, None, :]
        bu = w[p + "attention.bu"][:, None, :]

    def step(u_t, st):
        h, c = st
        z = (u_t + R.mm(h, wh, fmt)).reshape(2, B, N, 4, H)
        g = torch.einsum("dknm,dbmkh->dbnkh", R.rnd(adj, fmt),
                         R.rnd(z, fmt)) + bias
        c = torch.sigmoid(g[..., 1, :]) * c \
            + torch.sigmoid(g[..., 0, :]) * torch.tanh(g[..., 2, :])
        hy = torch.sigmoid(g[..., 3, :]) * torch.tanh(c)
        if attention:
            q = torch.relu(R.mm(hy, aw, fmt).sum(dim=2, keepdim=True))
            s = torch.tanh(R.mm(hy, awh, fmt) + R.mm(q, awq, fmt) + bs)
            a = R.mm(s, au, fmt)[..., 0] + bu
            hy = hy + hy * torch.sigmoid(a)[..., None]
        return hy, c

    hs, state = R.walk(step, seq2, state, n_valid)
    return torch.tanh(R.in_frame_order(hs)), state


def zero_state(cfg, B, device):
    N = cfg["num_nodes"]
    return tuple(
        tuple(torch.zeros(2, B, N, st["units_hidden"], device=device)
              for _ in range(2))
        for st in cfg["stages"])


def _net(cfg, w, s, x, state, n_valid, fmt):
    attention = cfg["cell"] in ("a3gc", "agc")
    p = f"s{s}."
    x = torch.relu(_conv(w, p + "linear_in.", x, fmt))
    x, state = _layer(w, p + "rnn1.", x, state, n_valid, attention, fmt)
    x, state = _layer(w, p + "rnn2.", x, state, n_valid, attention, fmt)
    return _conv(w, p + "linear_out.", x, fmt), state


@torch.no_grad()
def cascade(cfg, w, ori, acc, stats, n_valid, states=None, fmt="fp32"):
    r"""ori [B, T, 54], acc [B, T, 18] raw IMU frames of B streams,
    ``n_valid`` [B] their valid frames, ``states`` the three stages' states
    (None: zeros) → (local pose [B, T, 24, 3, 3], new states). Products on
    operands in format ``fmt``."""
    B, T = ori.shape[:2]
    if states is None:
        states = zero_state(cfg, B, ori.device)
    o, a = R.normalize(ori, acc, stats)
    imu = R.graph_inputs(o, a)                                  # [B,T,15,12]
    leaf, s1 = _net(cfg, w, 1, imu, states[0], n_valid, fmt)
    full, s2 = _net(cfg, w, 2, torch.cat((imu, leaf), dim=-1), states[1],
                    n_valid, fmt)
    out, s3 = _net(cfg, w, 3, torch.cat((imu, full), dim=-1), states[2],
                   n_valid, fmt)
    pose = R.full_local_pose(out.reshape(B * T, R.N_REDUCED, 3, 3))
    return pose.reshape(B, T, 24, 3, 3), (s1, s2, s3)
