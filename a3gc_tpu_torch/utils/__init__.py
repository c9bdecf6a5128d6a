from a3gc_tpu_torch.utils.checkpoint import (  # noqa: F401
    PARAMS_FILE,
    check_shapes,
    discover_latest,
    restore_params,
    save_params,
    write_params,
)
from a3gc_tpu_torch.utils.logging import (  # noqa: F401
    JsonlLogger,
    write_eval_report,
)
