"""Continuous-batching serving of the port over paged KV pools."""
from repro_torch.serving.sampling import GREEDY, SamplingParams
from repro_torch.serving.server import Server, ServerConfig, ServerStats, TokenEvent

__all__ = ["GREEDY", "SamplingParams", "Server", "ServerConfig", "ServerStats", "TokenEvent"]
