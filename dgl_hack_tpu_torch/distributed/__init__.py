"""The prefetch pipeline of ``dgl_hack_tpu.distributed``: host sampling
overlapped with training on the card.  The key-value store, the remote
samplers and the feature store are not ported yet (ROADMAP Queue 1,
item 9)."""
from .prefetch import PooledPrefetcher, ThreadedPrefetcher, prefetch_to_device

__all__ = ["ThreadedPrefetcher", "prefetch_to_device", "PooledPrefetcher"]
