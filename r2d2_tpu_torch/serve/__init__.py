"""The serving plane (port of r2d2_tpu/serve/, its first half): a trained
checkpoint served to many sessions at once. A device-resident session-state
cache with a host spill slab, a deadline micro-batcher with bucketed batch
shapes, a supervised serve loop (serial or pipelined two deep) with
checkpoint hot reload, int8 weights (ops/quantize.py), and in-process and
TCP clients. The multi-device fleet, the degradation ladder, the scenario
engine and the autoscaler (the JAX package's serve/multi.py, degrade.py,
scenarios.py, autoscale.py) are not ported yet."""

from r2d2_tpu_torch.serve.batcher import MicroBatcher, QueueFullError, ServeRequest
from r2d2_tpu_torch.serve.client import LocalClient, PolicyClient, serve_tcp
from r2d2_tpu_torch.serve.server import PolicyServer, ServeConfig, ServeResult, reference_act
from r2d2_tpu_torch.serve.state_cache import RecurrentStateCache

__all__ = [
    "LocalClient",
    "MicroBatcher",
    "PolicyClient",
    "PolicyServer",
    "QueueFullError",
    "RecurrentStateCache",
    "ServeConfig",
    "ServeRequest",
    "ServeResult",
    "reference_act",
    "serve_tcp",
]
