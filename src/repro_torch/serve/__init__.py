"""Serving: bucketed dynamic batching of the GAN generators."""
from repro_torch.serve.batching import BucketPolicy, QueueFull, pow2_buckets
from repro_torch.serve.gan_engine import GanEngine, GenRequest
from repro_torch.serve.metrics import ServeMetrics
