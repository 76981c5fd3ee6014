from repro_torch.data.pipeline import DataConfig, SyntheticLM, for_model

__all__ = ["DataConfig", "SyntheticLM", "for_model"]
