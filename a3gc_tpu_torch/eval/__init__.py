"""Online serving and evaluation of the port."""
from a3gc_tpu_torch.eval.run import (  # noqa: F401
    CascadeEvaluator,
    DipEvaluator,
    bucket_length,
    evaluate_sequences,
    prepare_graph_inputs,
    reduced_to_full,
)
from a3gc_tpu_torch.eval.streaming import (  # noqa: F401
    DipStreamingSession,
    StreamingCascade,
    StreamingSession,
    make_dip_window_step,
    make_window_step,
    streaming_outputs,
    streaming_outputs_multi,
    streaming_predictions,
    streaming_predictions_multi,
)
from a3gc_tpu_torch.eval.worst_frames import (  # noqa: F401
    compare_models,
    per_frame_errors,
    select_extreme_frames,
)
