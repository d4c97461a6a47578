"""Environment layer (port of r2d2_tpu/envs, the host envs): the catch
family on host numpy (multi-ball included), the scripted env of the exact
tests, and the Atari wrappers, import-gated (gymnasium with ALE and cv2 are
needed only when an Atari env is built). The pure-JAX families wait for
later slices."""

from r2d2_tpu_torch.envs.catch import (
    CatchEnv,
    CatchHostEnv,
    CatchVecEnv,
    catch_params,
    is_catch_name,
)
from r2d2_tpu_torch.envs.fake import ScriptedEnv

__all__ = ["CatchEnv", "CatchHostEnv", "CatchVecEnv", "ScriptedEnv", "make_env"]


def make_env(cfg, seed: int = 0):
    """Host-protocol (reset()/step(int)) env factory by cfg.env_name: the
    catch family, "scripted[:A]" (A pins the action count), and any other
    name as an ALE game."""
    name = cfg.env_name.lower()
    if is_catch_name(name):
        return CatchHostEnv(
            height=cfg.obs_shape[0], width=cfg.obs_shape[1], seed=seed,
            **catch_params(name),
        )
    if name == "scripted" or name.startswith("scripted:"):
        adim = int(name.split(":", 1)[1]) if ":" in name else cfg.action_dim
        return ScriptedEnv(obs_shape=cfg.obs_shape, action_dim=adim)
    from r2d2_tpu_torch.envs.atari import create_atari_env

    return create_atari_env(cfg.env_name, noop_start=True, seed=seed)
