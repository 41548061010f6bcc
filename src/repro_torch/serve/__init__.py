"""Serving: bucketed dynamic batching of the GAN generators, resilient
multi-replica serving of them, and the continuous-batching LM engine over
the KV-cache decode step."""
from repro_torch.serve.batching import BucketPolicy, QueueFull, pow2_buckets
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.gan_engine import GanEngine, GenRequest
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.replica import Replica
from repro_torch.serve.supervisor import (
    DispatchTimeout,
    NonFiniteOutput,
    ReplicaState,
    ReplicaSupervisor,
)
