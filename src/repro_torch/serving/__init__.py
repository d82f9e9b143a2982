"""repro_torch.serving — static and continuous-batching decode engines."""

from .engine import (
    ContinuousEngine,
    DecodeEngine,
    Request,
    Result,
    cache_batch_axes,
    pad_and_batch,
    scatter_cache_slots,
    serve,
    serve_continuous,
    serve_static,
)
