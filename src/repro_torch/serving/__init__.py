"""Continuous-batching serving engine over a block-wise-quantized paged
KV cache: scheduler + paged pool + decode/prefill steps."""
from repro_torch.serving.engine import (KV_FAMILIES, RequestResult,
                                        ServeEngine, make_decode_fn,
                                        make_prefill_fn)
from repro_torch.serving.kvcache import (KV_BITS, KVCacheConfig,
                                         KVPageLayout, PageAllocator,
                                         plan_kv_layout)
from repro_torch.serving.scheduler import MODES, Request, Scheduler, SlotState

__all__ = [
    "KV_BITS", "KV_FAMILIES", "KVCacheConfig", "KVPageLayout", "MODES",
    "PageAllocator", "Request", "RequestResult", "ServeEngine",
    "SlotState", "make_decode_fn", "make_prefill_fn", "plan_kv_layout",
]
