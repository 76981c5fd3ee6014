"""Continuous-batching serving of the port over paged KV pools: chunked
and batched prefill, the prefix cache with copy-on-write, priorities and
preemption, dispatch-ahead, speculative decoding, and the static-batch
baseline (counterpart of ``repro.serving``)."""
from repro_torch.serving.cache import (
    NULL_PAGE,
    OutOfPagesError,
    PagedKVCache,
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
from repro_torch.serving.spec import (
    ModelDrafter,
    NgramDrafter,
    SpecConfig,
    Verifier,
    effective_k,
    speculative_sample,
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
    "ModelDrafter",
    "NgramDrafter",
    "NULL_PAGE",
    "OutOfPagesError",
    "PagePool",
    "PagedKVCache",
    "QUEUED",
    "RUNNING",
    "Request",
    "SamplingParams",
    "Scheduler",
    "Server",
    "ServerConfig",
    "ServerStats",
    "SpecConfig",
    "StateStore",
    "StaticStats",
    "TokenEvent",
    "Verifier",
    "copy_kv_page",
    "effective_k",
    "filter_logits",
    "generate_static",
    "prefix_block_hashes",
    "sample_logits",
    "speculative_sample",
    "stack_params",
]
