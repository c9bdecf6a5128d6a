r"""Plain reference of the G-GRU cascade (trikpachu/A3GC-IP ``net_aagc.py``
``G_GRU_cell`` :305-368, ``G_GRU_net`` :673, ``PoseNet_GGRU`` :900, as
``train_ggru_tp.py`` trains it).

Per stage, on node features x [B, T, N, F]:

    x  = ReLU(A_in · (x W_in) + b_in)                  (AAGC projection)
    for layer in (rnn1, rnn2), one state h threaded through both:
        zi = x W_x + b_x                       [N, 3H], gates r, u, c
        per direction, per frame (direction 1 walks the frames backwards):
        msg = A · (h G)                        (learned A [N, N], G [H, H])
        zh  = msg W_h                          [N, 3H], no bias
        r = σ(zi_r + zh_r);  u = σ(zi_u + zh_u)
        c̃ = tanh(zi_c + r ⊙ zh_c);  h' = u ⊙ h + (1 − u) ⊙ c̃
        the layer's output: h' of both directions, concatenated (no tanh)
    y  = A_out · (x W_out) + b_out

The stages and inverse kinematics are those of the graph-LSTM cascade
(``reference/graph.py``). Departures from ``net_aagc.py:305-368``, none of
which changes the function:

* the six dense layers (r, u, c × input, hidden) are stored fused, [in, 3H]
  in r, u, c order, and G as [in, out]: the source's x·Wᵀ is x·W here;
* the adjacency is stored left-multiplying: the source's Aᵀ·(h·Gᵀ) is
  A·(h G) here, with A the transpose of the module's ``adjacency``;
* the source builds that adjacency from the template and then overwrites
  it with a Xavier draw (:334, :339-340; SURVEY N6): only the template's
  size is used. Here every weight, the adjacency with it, is drawn from
  the run's seed;
* both directions step together, frames past a stream's ``n_valid`` leave
  its state as it was (the source runs unpadded sequences), and a window
  of a stream starts from the state the previous one left.

Plain PyTorch in fp32 (TF32 switched off by the caller, ``common.no_tf32``),
products through ``common.mm`` / ``common.rnd`` so that the bfloat16 control
rounds every product's operands. It imports nothing of the program.
"""

from __future__ import annotations

import torch

from portbench.reference import common as R
from portbench.reference.graph import _conv


def _layer(w, p, x, h, n_valid, fmt):
    w_in = w[p + "w_in"]                            # [2, F, 3H]
    B, T, N, F = x.shape
    H = w_in.shape[-1] // 3
    zi = R.mm(x.reshape(1, B * T * N, F), w_in, fmt) + w[p + "b_in"][:, None]
    seq2 = R.in_walk_order(zi.reshape(2, B, T, N, 3 * H))
    g = w[p + "gcn_kernel"][:, None]                # [2, 1, H, H]
    adj = w[p + "adj"][:, None]                     # [2, 1, N, N]
    w_hid = w[p + "w_hid"][:, None]                 # [2, 1, H, 3H]

    def step(zi_t, st):
        (h,) = st
        msg = R.mm(adj, R.mm(h, g, fmt), fmt)
        zh = R.mm(msg, w_hid, fmt)
        r = torch.sigmoid(zi_t[..., :H] + zh[..., :H])
        u = torch.sigmoid(zi_t[..., H:2 * H] + zh[..., H:2 * H])
        c = torch.tanh(zi_t[..., 2 * H:] + r * zh[..., 2 * H:])
        return (u * h + (1.0 - u) * c,)

    hs, (h,) = R.walk(step, seq2, (h,), n_valid)
    return R.in_frame_order(hs), h


def zero_state(cfg, B, device):
    N = cfg["num_nodes"]
    return tuple(torch.zeros(2, B, N, st["units_hidden"], device=device)
                 for st in cfg["stages"])


def _net(w, s, x, h, n_valid, fmt):
    p = f"s{s}."
    x = torch.relu(_conv(w, p + "linear_in.", x, fmt))
    x, h = _layer(w, p + "rnn1.", x, h, n_valid, fmt)
    x, h = _layer(w, p + "rnn2.", x, h, n_valid, fmt)
    return _conv(w, p + "linear_out.", x, fmt), h


@torch.no_grad()
def cascade(cfg, w, ori, acc, stats, n_valid, states=None, fmt="fp32"):
    r"""As :func:`portbench.reference.graph.cascade`, for the G-GRU cascade:
    a stage's state is its h [2, B, N, H]."""
    B, T = ori.shape[:2]
    if states is None:
        states = zero_state(cfg, B, ori.device)
    o, a = R.normalize(ori, acc, stats)
    imu = R.graph_inputs(o, a)                                  # [B,T,15,12]
    leaf, s1 = _net(w, 1, imu, states[0], n_valid, fmt)
    full, s2 = _net(w, 2, torch.cat((imu, leaf), dim=-1), states[1],
                    n_valid, fmt)
    out, s3 = _net(w, 3, torch.cat((imu, full), dim=-1), states[2],
                   n_valid, fmt)
    pose = R.full_local_pose(out.reshape(B * T, R.N_REDUCED, 3, 3))
    return pose.reshape(B, T, 24, 3, 3), (s1, s2, s3)
