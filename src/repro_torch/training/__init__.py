from repro_torch.training.loop import (
    TrainState,
    chunked_xent,
    make_loss_fn,
    make_train_step,
)

__all__ = ["TrainState", "chunked_xent", "make_loss_fn", "make_train_step"]
