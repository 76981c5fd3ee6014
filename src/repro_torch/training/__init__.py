from repro_torch.training.loop import (
    TrainState,
    chunked_xent,
    init_train_state,
    make_loss_fn,
    make_train_step,
    state_specs,
)

__all__ = ["TrainState", "chunked_xent", "init_train_state", "make_loss_fn", "make_train_step",
           "state_specs"]
