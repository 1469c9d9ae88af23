"""The concurrent query runtime behind ``Session.submit`` / ``drain``: a
worker pool running drain groups, one pilot per pilot-sharing subgroup,
batched final launches, and a session-level LRU of finished answers.  The
synchronous drain is the degenerate case (workers=0, sharing off, cache
size 0)."""

from repro_torch.runtime.pool import AsyncRuntime, BackpressureError
from repro_torch.runtime.result_cache import (CachedAnswer, ResultCache,
                                              ResultCacheInfo)
from repro_torch.runtime.shared_pilot import execute_group, subgroup_by_pilot

__all__ = [
    "AsyncRuntime",
    "BackpressureError",
    "CachedAnswer",
    "ResultCache",
    "ResultCacheInfo",
    "execute_group",
    "subgroup_by_pilot",
]
