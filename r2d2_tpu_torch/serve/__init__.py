"""The serving plane (port of r2d2_tpu/serve/): a trained checkpoint served
to many sessions at once. A device-resident session-state cache with a host
spill slab, a deadline micro-batcher with bucketed batch shapes, a
supervised serve loop (serial or pipelined two deep) with checkpoint hot
reload, int8 weights (ops/quantize.py), in-process and TCP clients; a fleet
of replicas behind a session router (multi.py), the degradation ladder
(degrade.py), seeded traffic scenarios (scenarios.py) and the autoscaler
(autoscale.py)."""

from r2d2_tpu_torch.serve.autoscale import AutoscaleConfig, Autoscaler
from r2d2_tpu_torch.serve.batcher import MicroBatcher, QueueFullError, ServeRequest
from r2d2_tpu_torch.serve.client import LocalClient, PolicyClient, serve_tcp
from r2d2_tpu_torch.serve.degrade import RUNGS, DegradeConfig, DegradeController, SignalWindow
from r2d2_tpu_torch.serve.multi import MultiDeviceServer, SessionRouter
from r2d2_tpu_torch.serve.scenarios import (
    Arrival,
    ScenarioRunner,
    ScenarioSpec,
    arrival_trace,
    builtin_scenarios,
)
from r2d2_tpu_torch.serve.server import PolicyServer, ServeConfig, ServeResult, reference_act
from r2d2_tpu_torch.serve.state_cache import RecurrentStateCache

__all__ = [
    "Arrival",
    "AutoscaleConfig",
    "Autoscaler",
    "DegradeConfig",
    "DegradeController",
    "LocalClient",
    "MicroBatcher",
    "MultiDeviceServer",
    "PolicyClient",
    "PolicyServer",
    "QueueFullError",
    "RUNGS",
    "RecurrentStateCache",
    "ScenarioRunner",
    "ScenarioSpec",
    "ServeConfig",
    "ServeRequest",
    "ServeResult",
    "SessionRouter",
    "SignalWindow",
    "arrival_trace",
    "builtin_scenarios",
    "reference_act",
    "serve_tcp",
]
