"""Environment layer (port of r2d2_tpu/envs): the catch family on host numpy
(multi-ball included), the scripted env of the exact tests, and the Atari
wrappers, import-gated (gymnasium with ALE and cv2 are needed only when an
Atari env is built); the tensor cores of the on-device collector
(catch.TensorCatchEnv, fake.ScriptedFnEnv, procmaze.ProcMazeEnv and the
multi-task family: keydoor.KeyDoorEnv, drift.DriftEnv,
banditgrid.BanditGridEnv) and their host-protocol adapters
(functional.py)."""

from r2d2_tpu_torch.envs.banditgrid import (
    banditgrid_params,
    build_banditgrid_env,
    is_banditgrid_name,
)
from r2d2_tpu_torch.envs.catch import (
    CatchEnv,
    CatchHostEnv,
    CatchVecEnv,
    catch_params,
    is_catch_name,
)
from r2d2_tpu_torch.envs.drift import build_drift_env, drift_params, is_drift_name
from r2d2_tpu_torch.envs.fake import ScriptedEnv
from r2d2_tpu_torch.envs.keydoor import build_keydoor_env, is_keydoor_name, keydoor_params
from r2d2_tpu_torch.envs.procmaze import build_procmaze_env, is_procmaze_name, procmaze_params

__all__ = ["CatchEnv", "CatchHostEnv", "CatchVecEnv", "ScriptedEnv", "make_env"]


def is_multitask_family_name(name: str) -> bool:
    """True for the tensor cores of the multi-task family (keydoor, drift,
    banditgrid)."""
    return is_keydoor_name(name) or is_drift_name(name) or is_banditgrid_name(name)


def family_factory(name: str):
    """The build_*_env factory (obs_shape, max_episode_steps, name) -> core
    of a procmaze or multi-task family name, or None for other names."""
    for is_name, build in ((is_procmaze_name, build_procmaze_env),
                           (is_keydoor_name, build_keydoor_env),
                           (is_drift_name, build_drift_env),
                           (is_banditgrid_name, build_banditgrid_env)):
        if is_name(name):
            return build
    return None


def make_env(cfg, seed: int = 0):
    """Host-protocol (reset()/step(int)) env factory by cfg.env_name: the
    catch family, procmaze and the multi-task family (one env of the
    family's tensor core through FnHostEnv, on the CPU), "scripted[:A]" (A
    pins the action count), and any other name as an ALE game."""
    name = cfg.env_name.lower()
    if is_catch_name(name):
        return CatchHostEnv(
            height=cfg.obs_shape[0], width=cfg.obs_shape[1], seed=seed,
            **catch_params(name),
        )
    build = family_factory(name)
    if build is not None:
        from r2d2_tpu_torch.envs.functional import FnHostEnv

        return FnHostEnv(build, (cfg.obs_shape, cfg.max_episode_steps, name), seed=seed)
    if name == "scripted" or name.startswith("scripted:"):
        adim = int(name.split(":", 1)[1]) if ":" in name else cfg.action_dim
        return ScriptedEnv(obs_shape=cfg.obs_shape, action_dim=adim)
    from r2d2_tpu_torch.envs.atari import create_atari_env

    return create_atari_env(
        cfg.env_name, noop_start=True, noop_max=cfg.noop_max, seed=seed
    )
