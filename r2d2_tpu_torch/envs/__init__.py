"""Environment layer (port of r2d2_tpu/envs): the catch family on host
numpy. Atari, the scripted env and the pure-JAX families wait for later
slices."""

from r2d2_tpu_torch.envs.catch import (
    CatchEnv,
    CatchHostEnv,
    CatchVecEnv,
    catch_params,
    is_catch_name,
)

__all__ = ["CatchEnv", "CatchHostEnv", "CatchVecEnv", "make_env"]


def make_env(cfg, seed: int = 0):
    """Host-protocol (reset()/step(int)) env factory by cfg.env_name."""
    name = cfg.env_name.lower()
    if is_catch_name(name):
        return CatchHostEnv(
            height=cfg.obs_shape[0], width=cfg.obs_shape[1], seed=seed,
            **catch_params(name),
        )
    raise NotImplementedError(
        f"env {cfg.env_name!r} is not ported; the port runs the catch family"
    )
