r"""The graph-LSTM cascade family (A3GC, AAGC, AGC cells): the leaves of its
weights in the port's parameter layout, the port's objects built on them,
and the work of its products.

Per stage: ``linear_in`` (an AAGC projection, units_in → H), two
bidirectional graph-LSTM layers ``rnn1`` (F = H) and ``rnn2`` (F = 2H), one
state threaded through both, and ``linear_out`` (2H → units_out). Layouts
(the port's, ``a3gc_tpu_torch/models/cells.py``): dense kernels [in, out];
the fused gate kernel [2, F+H, 4H], gates i, f, g, o, the recurrent half in
the last H rows; left-multiplying adjacency; a leading direction axis of 2.

Initialisation (the benchmark's own): Xavier-uniform bounds for kernels
(per gate for the fused kernel), ±√(3/N) for adjacency entries (unit
variance of a row's sum), ±0.1 for biases.
"""

from __future__ import annotations

import math

from portbench import work as W


def _xavier(fan_in: int, fan_out: int) -> float:
    return math.sqrt(6.0 / (fan_in + fan_out))


def _attention(cfg) -> bool:
    return cfg["cell"] in ("a3gc", "agc")


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
            spec += [(q + "kernel", (2, F + H, 4 * H), _xavier(F + H, H)),
                     (q + "adj", (2, 4, N, N), adj_b),
                     (q + "bias", (2, 4, H), 0.1)]
            if _attention(cfg):
                spec += [(q + "attention." + k, (2, H, H), _xavier(H, H))
                         for k in ("w", "wq", "wh")]
                spec += [(q + "attention.u", (2, H, 1), _xavier(H, 1)),
                         (q + "attention.bs", (2, H), 0.1),
                         (q + "attention.bu", (2, N), 0.1)]
        spec += [(p + "linear_out.kernel", (2 * H, uo), _xavier(2 * H, uo)),
                 (p + "linear_out.adj", (N, N), adj_b),
                 (p + "linear_out.bias", (uo,), 0.1)]
    return spec


def port_cascade(cfg, w):
    r"""The port's (CascadeConfig, params3) on the tensors ``w``, the
    configs built as ``a3gc_tpu_torch.graft_entry._cascade`` and ``cli
    serve`` build them."""
    from a3gc_tpu_torch.models import cells as C
    from a3gc_tpu_torch.models import nets as N
    from a3gc_tpu_torch.models.pipeline import CascadeConfig, PoseNetConfig

    def conv(p):
        return C.GraphConvParams(kernel=w[p + "kernel"], adj=w[p + "adj"],
                                 bias=w[p + "bias"])

    def cell(p):
        att = None
        if _attention(cfg):
            att = C.AttentionParams(**{k: w[p + "attention." + k] for k in
                                       ("w", "wq", "wh", "u", "bs", "bu")})
        return C.GCNLSTMCellParams(kernel=w[p + "kernel"], adj=w[p + "adj"],
                                   bias=w[p + "bias"], attention=att)

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


def scan_calls(cfg, S: int, T: int):
    r"""``[(kernel, FLOP, bytes)]`` of the recurrent scans of one cascade
    call on S streams of T frames."""
    out = []
    for st in cfg["stages"]:
        H = st["units_hidden"]
        for F in (H, 2 * H):
            flop, nbytes = W.layer_work(S, T, F, H, _attention(cfg), False,
                                        cfg["num_nodes"])
            out.append(("gcn_lstm", flop, nbytes))
    return out


def flop_per_frame(cfg) -> int:
    r"""Every product of the three stages for one frame of one stream:
    the projections' dense and adjacency products, the hoisted input
    projections and the scans' recurrent, adjacency and attention
    products (:func:`work.layer_work`), both directions."""
    N = cfg["num_nodes"]
    total = 0
    for st in cfg["stages"]:
        ui, uo, H = st["units_in"], st["units_out"], st["units_hidden"]
        total += 2 * N * ui * H + 2 * N * N * H
        for F in (H, 2 * H):
            total += W.layer_work(1, 1, F, H, _attention(cfg), True, N)[0]
        total += 2 * N * 2 * H * uo + 2 * N * N * uo
    return total
