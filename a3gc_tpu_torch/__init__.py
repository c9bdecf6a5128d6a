r"""a3gc_tpu_torch — the PyTorch/CUDA port of ``a3gc_tpu``.

The JAX package ``a3gc_tpu`` is the reference this package is held to. The
port mirrors its module layout and names, keeps its parameter layouts at
every public function (dense kernels ``[in, out]``, the fused gate kernel
``[F+H, 4H]`` in gate order i, f, g, o with the recurrent half in the last H
rows, left-multiplying adjacency, a leading direction axis of 2), and runs
its recurrent scans as CUDA kernels written for Hopper: ``ops/csrc/
gcn_lstm.cu`` (graph-LSTM cells), ``ggru.cu`` (G-GRU) and ``lstm.cu`` (the
dense LSTM of DIP and TransPose, one direction or two).

What runs today, at inference: the A3GC/AAGC/AGC and G-GRU graph cascades
and the TransPose cascade, offline (``models.pipeline.cascade_apply``) and
online (``eval.streaming.StreamingCascade``), the DIP net online
(``eval.streaming.DipStreamingSession``) and single nets
(``eval.streaming.StreamingSession``) — plain windows or buffered
lookahead/history context, per-slot ``active`` masks, ``reset`` and
``flush`` — and the HTTP front end over them: ``serve.PoseServer``,
``client.PoseClient`` and ``python -m a3gc_tpu_torch.cli serve``, on
trained checkpoints (the reference's ``.tar`` files through
``compat.torch_import`` / ``compat.torch_export``, the port's own
checkpoint directories through ``utils``); and evaluation: the SMPL body
model with FK and skinning (``smpl``), the motion-error metrics
(``metrics``), ``eval.CascadeEvaluator`` / ``eval.DipEvaluator`` and
``python -m a3gc_tpu_torch.cli evaluate``. Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; they raise when CUDA is asked
for and absent.

The package imports ``torch`` and numpy only — never ``jax``, ``flax`` or
any module of ``a3gc_tpu``.
"""

__version__ = "0.1.0"
