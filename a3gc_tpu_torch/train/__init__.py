from a3gc_tpu_torch.train.loop import (  # noqa: F401
    CheckpointRetention,
    DIPRunner,
    GracefulInterrupt,
    StageRunner,
    TrainState,
    make_optimizer,
    run_cascade_training,
    seeded_generator,
    stage_inputs_flat,
    stage_inputs_graph,
)
