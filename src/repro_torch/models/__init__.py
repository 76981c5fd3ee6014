"""Models of the port: the decoder and its building blocks, the model
registry and the input specs of each cell."""
from repro_torch.models.registry import (
    ShapeDtype,
    batch_shapes,
    build,
    decode_input_specs,
    make_batch,
    meta_params,
    train_input_specs,
)
from repro_torch.models.transformer import MeshCtx, Transformer

__all__ = ["MeshCtx", "ShapeDtype", "Transformer", "batch_shapes", "build",
           "decode_input_specs", "make_batch", "meta_params", "train_input_specs"]
