"""``dgl_hack_tpu.distributed`` on the port: the prefetch pipeline (host
sampling overlapped with training on the card), the multi-process
bootstrap, the key-value store over the native TCP transport, the
feature store and the remote sampler service."""
from .bootstrap import initialize_from_env, read_ip_config
from .dis_sampler import (SamplerPool, SamplerReceiver, SamplerSender,
                          deserialize_sample, serialize_sample)
from .feature_store import (FeatureStore, attach_shared_graph,
                            save_shared_graph)
from .kvstore import (KVClient, KVServer, LoopbackTransport,
                      NativeTransport, make_transports)
from .prefetch import PooledPrefetcher, ThreadedPrefetcher, prefetch_to_device

__all__ = ["ThreadedPrefetcher", "prefetch_to_device", "PooledPrefetcher",
           "initialize_from_env", "read_ip_config", "FeatureStore",
           "attach_shared_graph", "save_shared_graph", "KVServer",
           "KVClient", "NativeTransport", "LoopbackTransport",
           "make_transports", "SamplerSender", "SamplerReceiver",
           "SamplerPool", "serialize_sample", "deserialize_sample"]
