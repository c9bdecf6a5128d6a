"""The motion-error metrics of the port."""
from a3gc_tpu_torch.metrics.evaluator import (  # noqa: F401
    FullMotionEvaluator,
    PoseEvaluator,
    binary_classification_errors,
    binary_confusion_matrix,
    full_motion_metrics,
    masked_global_angle_per_frame,
    mean_per_joint_errors,
    mesh_error,
    per_joint_errors,
    position_error,
    rotation_error,
)
