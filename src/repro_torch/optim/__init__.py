from repro_torch.optim.adamw import AdamW, cosine_schedule, global_norm

__all__ = ["AdamW", "cosine_schedule", "global_norm"]
