r"""The G-GRU cascade family: the leaves of its weights in the port's parameter
layout, the port's objects built on them, and the work of its products.

Per stage: ``linear_in`` (an AAGC projection, units_in → H), two
bidirectional G-GRU layers ``rnn1`` (F = H) and ``rnn2`` (F = 2H), one
state h threaded through both, and ``linear_out`` (2H → units_out).
Layouts (the port's, ``a3gc_tpu_torch/models/cells.py`` ``GGRUCellParams``)
with a leading direction axis of 2: ``w_in`` [2, F, 3H] and ``b_in``
[2, 3H] (gates r, u, c), ``w_hid`` [2, H, 3H] (no bias), ``gcn_kernel``
[2, H, H], ``adj`` [2, N, N] left-multiplying.

Initialisation (the benchmark's own, with ``cells.init_ggru_cell``'s
bounds): torch.nn.Linear's ±1/√fan_in for ``w_in``, ``b_in`` and
``w_hid``, Xavier-uniform for ``gcn_kernel`` and ``adj``; the graph convs
in and out as the graph-LSTM family draws them (Xavier kernels, ±√(3/N)
adjacency, ±0.1 biases).
"""

from __future__ import annotations

import math

from portbench.families.graph import _xavier

N_NODES = 15


def param_spec(cfg):
    N = cfg["num_nodes"]
    adj_b = math.sqrt(3.0 / N)
    spec = []
    for s, st in enumerate(cfg["stages"], 1):
        ui, uo, H = st["units_in"], st["units_out"], st["units_hidden"]
        p = f"s{s}."
        spec += [(p + "linear_in.kernel", (ui, H), _xavier(ui, H)),
                 (p + "linear_in.adj", (N, N), adj_b),
                 (p + "linear_in.bias", (H,), 0.1)]
        for layer, F in (("rnn1", H), ("rnn2", 2 * H)):
            q = f"{p}{layer}."
            spec += [(q + "w_in", (2, F, 3 * H), 1 / math.sqrt(F)),
                     (q + "b_in", (2, 3 * H), 1 / math.sqrt(F)),
                     (q + "w_hid", (2, H, 3 * H), 1 / math.sqrt(H)),
                     (q + "gcn_kernel", (2, H, H), _xavier(H, H)),
                     (q + "adj", (2, N, N), _xavier(N, N))]
        spec += [(p + "linear_out.kernel", (2 * H, uo), _xavier(2 * H, uo)),
                 (p + "linear_out.adj", (N, N), adj_b),
                 (p + "linear_out.bias", (uo,), 0.1)]
    return spec


def port_cascade(cfg, w):
    r"""The port's (CascadeConfig, params3) on the tensors ``w``, the
    configs built as ``cli evaluate --model ggru`` builds them."""
    from a3gc_tpu_torch.models import cells as C
    from a3gc_tpu_torch.models import nets as N
    from a3gc_tpu_torch.models.pipeline import CascadeConfig, PoseNetConfig

    def conv(p):
        return C.GraphConvParams(kernel=w[p + "kernel"], adj=w[p + "adj"],
                                 bias=w[p + "bias"])

    def cell(p):
        return C.GGRUCellParams(**{k: w[p + k] for k in
                                   ("w_in", "b_in", "w_hid", "gcn_kernel",
                                    "adj")})

    stages, params3 = [], []
    for s, st in enumerate(cfg["stages"], 1):
        stages.append(PoseNetConfig(
            net=N.GraphNetConfig(cell=cfg["cell"], units_in=st["units_in"],
                                 units_out=st["units_out"],
                                 units_hidden=st["units_hidden"],
                                 num_nodes=cfg["num_nodes"],
                                 precision=cfg["precision"]),
            rotsize=st["rotsize"]))
        p = f"s{s}."
        params3.append(N.GraphNetParams(
            linear_in=conv(p + "linear_in."), rnn1=cell(p + "rnn1."),
            rnn2=cell(p + "rnn2."), linear_out=conv(p + "linear_out.")))
    return CascadeConfig(*stages), tuple(params3)


def ggru_layer_work(S, T, F, H, hoist, tf32=False, N=N_NODES):
    r"""(FLOP, bytes) of one bidirectional G-GRU layer call (a copy of
    ``chip_smoke.py``'s), each input read once and each output written
    once; ``hoist=False`` counts the scan alone (zi → y, state). The least
    the function needs: adj·(h·G)·W_hid = (adj·h)·(G·W_hid), so
    6·N·H² + 2·N²·H FLOP per (stream, direction, frame) in the scan and one
    G·W_hid (2·H·H·3H) per direction. With TF32 operands (``tf32``) the
    function is the cell's order, whose products round where the fold's
    do not: 8·N·H² + 2·N²·H FLOP a frame and no fold."""
    flop = (2 * T * S * (8 * N * H * H + 2 * N * N * H) if tf32 else
            2 * T * S * (6 * N * H * H + 2 * N * N * H)
            + 2 * 2 * H * H * 3 * H)
    params = 2 * (H * H + N * N + 3 * H * H)
    state = 2 * S * N * H
    if hoist:
        flop += 2 * 2 * S * T * N * F * 3 * H
        params += 2 * (F * 3 * H + 3 * H)
        read = S * T * N * F + params + state
    else:
        read = 2 * S * T * N * 3 * H + params + state
    write = S * T * N * 2 * H + state
    return flop, 4 * (read + write) + 4 * S


def scan_calls(cfg, S: int, T: int):
    r"""``[(kernel, FLOP, bytes)]`` of the recurrent scans of one cascade
    call on S streams of T frames, in the configuration's format
    ("default": TF32 operands, the cell's order)."""
    tf32 = cfg["precision"] == "default"
    out = []
    for st in cfg["stages"]:
        H = st["units_hidden"]
        for F in (H, 2 * H):
            flop, nbytes = ggru_layer_work(S, T, F, H, False, tf32,
                                           cfg["num_nodes"])
            out.append(("ggru", flop, nbytes))
    return out


def flop_per_frame(cfg) -> int:
    r"""Every product of the three stages for one frame of one stream:
    the projections' dense and adjacency products, the hoisted input
    projections and the scans' products in the cell's own order
    (:func:`ggru_layer_work` with ``tf32``: 8·N·H² + 2·N²·H a frame and
    direction), both directions."""
    N = cfg["num_nodes"]
    total = 0
    for st in cfg["stages"]:
        ui, uo, H = st["units_in"], st["units_out"], st["units_hidden"]
        total += 2 * N * ui * H + 2 * N * N * H
        for F in (H, 2 * H):
            total += ggru_layer_work(1, 1, F, H, True, True, N)[0]
        total += 2 * N * 2 * H * uo + 2 * N * N * uo
    return total
