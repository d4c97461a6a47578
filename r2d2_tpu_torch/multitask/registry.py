"""Task registry: env name -> dense task id + union geometry (port of
r2d2_tpu/multitask/registry.py).

One shared network serves every task, so the registry computes the union
action space (the largest native action count; the head's per-task mask
floors each task's padding, models/r2d2.py) and keeps one obs_shape, at
which every family core renders. Per-task discounts come from the gamma
ladder (ops/epsilon.multitask_gamma_ladder) unless pinned.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

from r2d2_tpu_torch.config import R2D2Config
from r2d2_tpu_torch.ops.epsilon import multitask_gamma_ladder

# launcher shorthand (sweep.py --multitask maze,drift,bandit) -> env names
TASK_ALIASES = {
    "maze": "keydoor",
    "keydoor": "keydoor",
    "drift": "drift",
    "bandit": "banditgrid",
    "banditgrid": "banditgrid",
    "catch": "catch",
}


class TaskSpec(NamedTuple):
    task_id: int
    name: str         # launcher alias or the env name itself
    env_name: str     # the full env name the factories parse
    action_dim: int   # native action count (<= the union cfg.action_dim)
    gamma: float      # the task's discount (stored into replayed returns)


def resolve_task_names(spec: str) -> List[str]:
    """"maze,drift,bandit" -> env names, aliases resolved, order kept;
    other names (full env names such as "keydoor:4:2") pass through."""
    names = [s.strip() for s in spec.split(",") if s.strip()]
    if not names:
        raise ValueError(f"no task names in {spec!r}")
    return [TASK_ALIASES.get(n.lower(), n) for n in names]


def _native_action_dim(cfg: R2D2Config, env_name: str) -> int:
    """The env's own action count at this geometry, read off its tensor
    core, so the registry cannot drift from the factories."""
    from r2d2_tpu_torch.train import build_fn_env

    return build_fn_env(cfg.replace(env_name=env_name)).NUM_ACTIONS


def build_registry(
    cfg: R2D2Config,
    names: Sequence[str],
    gammas: Optional[Sequence[float]] = None,
    gamma_min: float = 0.97,
) -> Tuple[R2D2Config, List[TaskSpec]]:
    """Task names -> (the validated multi-task config, the specs). The
    config carries num_tasks, multitask_envs, task_action_dims,
    task_gammas and the union action_dim; task 0 keeps cfg.gamma and the
    later tasks step down the log(1 - gamma) ladder to gamma_min."""
    env_names = resolve_task_names(",".join(names)) if isinstance(names, str) else [
        TASK_ALIASES.get(n.lower(), n) for n in names
    ]
    T = len(env_names)
    if T < 1:
        raise ValueError("need at least one task")
    if len(set(env_names)) != T:
        raise ValueError(f"duplicate task envs in {env_names}")
    dims = [_native_action_dim(cfg, n) for n in env_names]
    if gammas is None:
        g_max = cfg.gamma
        gammas = [float(g) for g in multitask_gamma_ladder(T, min(gamma_min, g_max), g_max)]
    else:
        gammas = [float(g) for g in gammas]
        if len(gammas) != T:
            raise ValueError(f"{len(gammas)} gammas for {T} tasks")
    out = cfg.replace(
        env_name=env_names[0],
        action_dim=max(dims),
        num_tasks=T,
        multitask_envs=tuple(env_names),
        task_action_dims=tuple(dims),
        task_gammas=tuple(gammas),
    )
    specs = [TaskSpec(task_id=t, name=env_names[t], env_name=env_names[t],
                      action_dim=dims[t], gamma=gammas[t]) for t in range(T)]
    return out, specs
