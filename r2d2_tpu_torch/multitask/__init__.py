"""Multi-task plane (port of r2d2_tpu/multitask): ONE learner over a family
of tensor-core envs.

The registry (registry.py) maps env names to dense task ids and computes
the union geometry one shared network needs (the largest native action
count, the shared obs_shape); the trainer (trainer.py) runs per-task actor
fleets into per-task replay buffers and trains one task-conditioned R2D2 on
task-stratified batches. Everything is gated on cfg.num_tasks > 1: the
single-task path is untouched.
"""

from r2d2_tpu_torch.multitask.registry import (  # noqa: F401
    TASK_ALIASES,
    TaskSpec,
    build_registry,
    resolve_task_names,
)
from r2d2_tpu_torch.multitask.trainer import MultiTaskTrainer  # noqa: F401
