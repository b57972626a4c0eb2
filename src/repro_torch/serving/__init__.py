"""Elastic serving plane of the port: continuous batching + KV-cache
migration on the recovery fabric, mirroring ``repro.serving`` (the JAX
package).

The inference-side counterpart of the training ``VirtualCluster``: the same
``core.events`` vocabulary, the same event -> plan -> apply recovery path,
the same content-addressed RNG invariant — applied to an admission queue,
slot-indexed KV pools, and replica-level capacity changes.  Decoder-only
dense and Mamba2 models serve; prefills run the flash-attention and SSD
kernels on the card.

Quick use::

    from repro_torch.serving import ServingEngine, Request, SamplerConfig
    eng = ServingEngine(cfg, n_replicas=2, slots_per_replica=4, max_len=64)
    eng.submit(Request(rid=0, arrival=0.0, prompt=prompt, max_new_tokens=16))
    eng.drain()
    print(eng.summary())
"""
from .engine import Replica, ServeCostModel, ServingEngine, offline_generate
from .kvcache import (KVPool, gather_slots, migrate_slot, scatter_slots,
                      slot_kv_bytes)
from .policies import (SERVE_POLICIES, ChameleonServePolicy, DropPolicy,
                       ElasWaveServePolicy, RebuildServePolicy,
                       ServeRecoveryPolicy)
from .request import SLO, Request, RequestState, poisson_arrivals
from .sampling import SAMPLE_STREAM_ID, SamplerConfig, sample_tokens

__all__ = [
    "ChameleonServePolicy", "DropPolicy", "ElasWaveServePolicy", "KVPool",
    "RebuildServePolicy", "Replica", "Request", "RequestState",
    "SAMPLE_STREAM_ID", "SERVE_POLICIES", "SLO", "SamplerConfig",
    "ServeCostModel", "ServeRecoveryPolicy", "ServingEngine", "gather_slots",
    "migrate_slot", "offline_generate", "poisson_arrivals", "sample_tokens",
    "scatter_slots", "slot_kv_bytes",
]
