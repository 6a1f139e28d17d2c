"""Online request-level serving runtime (counterpart of
``repro.serving``): requests arriving over time, queueing, coalescing and
tail latency, over the same stage registry as the offline engines.

* :mod:`repro_torch.serving.batcher` — dynamic micro-batching with
  depth-bounded, SLO-tiered admission control (priority classes with
  per-class deadlines), and ``pad_to_bucket``;
* :mod:`repro_torch.serving.cache` — content-addressed result caching:
  exact sha256 tier, near-duplicate embedding tier, and the
  dedup-in-flight table;
* :mod:`repro_torch.serving.server` — :class:`DetectionServer`:
  per-request futures over a persistent service-mode lane executor (each
  lane a CUDA stream on the card), straggler re-execution, live lane
  reallocation;
* :mod:`repro_torch.serving.replica` — :class:`Replica`: one server
  wrapped for fleet membership (identity, device pin, health,
  injectable :class:`FaultPlan` fault hooks);
* :mod:`repro_torch.serving.router` — :class:`FleetRouter`: rendezvous
  content-digest routing over N replicas, spill-over on backpressure,
  crash re-execution, rolling reconfigure;
* :mod:`repro_torch.serving.metrics` — queue depth / batch occupancy /
  latency percentiles / throughput / cache + admission registry.
"""
from repro_torch.serving.batcher import (AdmissionError, BatcherConfig,
                                         MicroBatcher)
from repro_torch.serving.cache import (EmbeddingCache, InFlightTable,
                                       ResultCache)
from repro_torch.serving.metrics import MetricsRegistry
from repro_torch.serving.replica import FaultPlan, Replica, ReplicaCrashed
from repro_torch.serving.router import FleetRouter
from repro_torch.serving.server import DetectionServer

__all__ = ["AdmissionError", "BatcherConfig", "MicroBatcher",
           "ResultCache", "EmbeddingCache", "InFlightTable",
           "MetricsRegistry", "DetectionServer",
           "Replica", "FaultPlan", "ReplicaCrashed", "FleetRouter"]
