r"""The yardstick's arithmetic: the peaks of the card and the operations and
bytes a recurrent layer call needs (copies of ``chip_smoke.py``'s
``layer_work``, ``lstm_layer_work`` and ``bound``).

Each count is of the work the inputs need, whatever implements it: a layer
call on S streams of T frames, each input read once and each output written
once. ``hoist=False`` counts the scan alone (the hoisted input projection u
→ y and the states), which is what the scan kernels compute.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
PEAK_FP32_FLOPS = 67e12     # fp32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12    # TF32 on the tensor cores
PEAK_HBM_BYTES = 3.35e12    # HBM3

N_NODES = 15


def peak_flops(precision: str) -> float:
    r"""The peak of the format a configuration's products run in on the
    card: "default" → TF32 operands, "highest" → fp32."""
    return {"default": PEAK_TF32_FLOPS, "highest": PEAK_FP32_FLOPS}[precision]


def layer_work(S, T, F, H, attention, hoist, N=N_NODES):
    r"""(FLOP, bytes) one bidirectional graph-LSTM layer call needs."""
    rec = 2 * N * H * 4 * H + 2 * 4 * N * N * H
    if attention:
        rec += 2 * 2 * N * H * H + 2 * H * H + 2 * N * H
    flop = 2 * T * S * rec
    params = 2 * (4 * H * H + 4 * N * N + 4 * H)
    if attention:
        params += 2 * (3 * H * H + 2 * H + N)
    state = 2 * 2 * S * N * H
    if hoist:
        flop += 2 * 2 * S * T * N * F * 4 * H
        params += 2 * F * 4 * H
        read = S * T * N * F + params + state
    else:
        read = 2 * S * T * N * 4 * H + params + state
    write = S * T * N * 2 * H + state
    return flop, 4 * (read + write) + 4 * S


def lstm_layer_work(S, T, F, H, hoist, D=2):
    r"""(FLOP, bytes) of one dense LSTM layer call of D directions: 8·H²
    FLOP per (stream, direction, frame) in the scan."""
    flop = D * T * S * 8 * H * H
    params = D * 4 * H * H
    state = D * 2 * S * H
    if hoist:
        flop += D * 2 * S * T * F * 4 * H
        params += D * (F * 4 * H + 2 * 4 * H)
        read = S * T * F + params + state
    else:
        read = D * S * T * 4 * H + params + state
    write = S * T * D * H + state
    return flop, 4 * (read + write) + 4 * S


def bound_seconds(flop, nbytes, peak=PEAK_TF32_FLOPS):
    r"""The least time the card could take: the larger of operations over
    the peak and bytes over the bandwidth."""
    return max(flop / peak, nbytes / PEAK_HBM_BYTES)
