"""Continuous-batching serving of the port over paged KV pools: chunked
and batched prefill, the prefix cache with copy-on-write, priorities and
preemption, dispatch-ahead, and the static-batch baseline (counterpart of
``repro.serving`` without speculative decoding)."""
from repro_torch.serving.cache import (
    NULL_PAGE,
    OutOfPagesError,
    PagePool,
    StateStore,
    copy_kv_page,
    prefix_block_hashes,
)
from repro_torch.serving.sampling import (
    GREEDY,
    SamplingParams,
    filter_logits,
    sample_logits,
    stack_params,
)
from repro_torch.serving.scheduler import (
    FINISH_EOS,
    FINISH_LENGTH,
    FINISHED,
    QUEUED,
    RUNNING,
    Request,
    Scheduler,
)
from repro_torch.serving.server import (
    Server,
    ServerConfig,
    ServerStats,
    StaticStats,
    TokenEvent,
    generate_static,
)

__all__ = [
    "FINISH_EOS",
    "FINISH_LENGTH",
    "FINISHED",
    "GREEDY",
    "NULL_PAGE",
    "OutOfPagesError",
    "PagePool",
    "QUEUED",
    "RUNNING",
    "Request",
    "SamplingParams",
    "Scheduler",
    "Server",
    "ServerConfig",
    "ServerStats",
    "StateStore",
    "StaticStats",
    "TokenEvent",
    "copy_kv_page",
    "filter_logits",
    "generate_static",
    "prefix_block_hashes",
    "sample_logits",
    "stack_params",
]
