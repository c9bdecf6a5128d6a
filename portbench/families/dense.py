r"""The dense biLSTM cascade family (TransPose): the leaves of its weights in
the port's parameter layout, the port's objects built on them, and the
work of its products.

Per stage (a DIP net): ``linear1`` (n_input → H, ReLU), ``layers``
bidirectional LSTM layers (F = H, then 2H; each layer carries its own
state), ``linear2`` (2H → n_output). Layouts (the port's,
``a3gc_tpu_torch/models/nets.py``): dense kernels [in, out]; per layer
``w_ih`` [2, F, 4H], ``w_hh`` [2, H, 4H], ``b_ih`` and ``b_hh`` [2, 4H],
gates i, f, g, o.

Initialisation (the benchmark's own, with torch.nn.Linear's and
torch.nn.LSTM's bounds): ±1/√fan_in for the dense layers, ±1/√H for the
LSTM layers.
"""

from __future__ import annotations

import math

from portbench import work as W


def param_spec(cfg):
    spec = []
    for s, st in enumerate(cfg["stages"], 1):
        ni, no, H = st["n_input"], st["n_output"], st["n_hidden"]
        p = f"s{s}."
        spec += [(p + "linear1.kernel", (ni, H), 1 / math.sqrt(ni)),
                 (p + "linear1.bias", (H,), 1 / math.sqrt(ni))]
        for i in range(cfg["layers"]):
            F = H if i == 0 else 2 * H
            q, b = f"{p}lstm.{i}.", 1 / math.sqrt(H)
            spec += [(q + "w_ih", (2, F, 4 * H), b),
                     (q + "w_hh", (2, H, 4 * H), b),
                     (q + "b_ih", (2, 4 * H), b),
                     (q + "b_hh", (2, 4 * H), b)]
        spec += [(p + "linear2.kernel", (2 * H, no), 1 / math.sqrt(2 * H)),
                 (p + "linear2.bias", (no,), 1 / math.sqrt(2 * H))]
    return spec


def port_cascade(cfg, w):
    r"""The port's (CascadeConfig, params3) on the tensors ``w``, the
    configs built as ``a3gc_tpu_torch.graft_entry._cascade`` and ``cli
    serve --model tp`` build them."""
    from a3gc_tpu_torch.models import nets as N
    from a3gc_tpu_torch.models.pipeline import CascadeConfig, PoseNetConfig

    stages, params3 = [], []
    for s, st in enumerate(cfg["stages"], 1):
        stages.append(PoseNetConfig(
            net=N.DIPConfig(n_input=st["n_input"], n_output=st["n_output"],
                            n_hidden=st["n_hidden"], n_layers=cfg["layers"],
                            precision=cfg["precision"]),
            rotsize=st["rotsize"]))
        p = f"s{s}."
        lstm = [N.LSTMLayerParams(**{k: w[f"{p}lstm.{i}.{k}"] for k in
                                     ("w_ih", "w_hh", "b_ih", "b_hh")})
                for i in range(cfg["layers"])]
        params3.append(N.DIPParams(
            N.DenseParams(w[p + "linear1.kernel"], w[p + "linear1.bias"]),
            lstm,
            N.DenseParams(w[p + "linear2.kernel"], w[p + "linear2.bias"])))
    return CascadeConfig(*stages), tuple(params3)


def scan_calls(cfg, S: int, T: int):
    r"""``[(kernel, FLOP, bytes)]`` of the recurrent scans of one cascade
    call on S streams of T frames."""
    out = []
    for st in cfg["stages"]:
        H = st["n_hidden"]
        for i in range(cfg["layers"]):
            flop, nbytes = W.lstm_layer_work(S, T, H if i == 0 else 2 * H,
                                             H, False)
            out.append(("lstm", flop, nbytes))
    return out


def flop_per_frame(cfg) -> int:
    r"""Every product of the three stages for one frame of one stream:
    the dense layers, the hoisted input projections and the recurrent
    products (:func:`work.lstm_layer_work`), both directions."""
    total = 0
    for st in cfg["stages"]:
        ni, no, H = st["n_input"], st["n_output"], st["n_hidden"]
        total += 2 * ni * H + 2 * 2 * H * no
        for i in range(cfg["layers"]):
            total += W.lstm_layer_work(1, 1, H if i == 0 else 2 * H, H,
                                       True)[0]
    return total
