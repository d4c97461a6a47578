"""The port's catch env, actor and trainer (r2d2_tpu_torch/envs, actor.py,
train.py) against the JAX package.

- Catch: step and render from identical states, bit for bit, for the plain,
  memory and slow-fall variants. (Resets cannot match: the JAX package draws
  them from jax.random, the port from a numpy Generator.)
- Actor: both VectorizedActors on twin numpy env streams, with converted
  parameters and the same seed, push the same blocks: observations, actions,
  rewards and sequence geometry bit for bit; Q rows and stored carries to
  1e-5, initial priorities to rtol 1e-4.
- Trainer: a short CPU run of the inline loop, and the CLI's refusal to run
  on a machine without a GPU unless it is asked for the CPU.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2_tpu.actor import ParamStore as RefParamStore
from r2d2_tpu.actor import VectorizedActor as RefActor
from r2d2_tpu.config import tiny_test as jax_tiny_test
from r2d2_tpu.envs.catch import CatchEnv as RefCatchEnv
from r2d2_tpu.envs.catch import CatchState as RefCatchState
from r2d2_tpu.models.r2d2 import init_params as jax_init_params
from r2d2_tpu_torch import train
from r2d2_tpu_torch.actor import ParamStore, VectorizedActor
from r2d2_tpu_torch.config import resolve_device, tiny_test
from r2d2_tpu_torch.envs import make_env
from r2d2_tpu_torch.envs.catch import CatchEnv, CatchState, CatchVecEnv, catch_params
from r2d2_tpu_torch.interop import params_from_flax
from r2d2_tpu_torch.models.r2d2 import R2D2Network, init_params, initial_carry
from r2d2_tpu_torch.ops import lstm_kernel
from r2d2_tpu_torch.ops.epsilon import epsilon_ladder

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["catch", "memory_catch", "memory_catch:5:3"])
@pytest.mark.parametrize("size", [12, 84])
def test_catch_step_and_render_match_reference(name, size):
    kw = catch_params(name)
    ref, port = RefCatchEnv(size, size, **kw), CatchEnv(size, size, **kw)
    rng = np.random.default_rng(size)
    E = 64
    s = CatchState(
        ball_x=rng.integers(0, size, E).astype(np.int32),
        ball_y=rng.integers(0, size - 2, E).astype(np.int32),
        paddle_x=rng.integers(0, size, E).astype(np.int32),
        t=rng.integers(0, 20, E).astype(np.int32),
        balls_left=np.ones(E, np.int32),
    )
    keys = jax.random.split(jax.random.PRNGKey(0), E)
    rs = RefCatchState(*(jnp.asarray(v) for v in (s.ball_x, s.ball_y, s.paddle_x)),
                       keys, jnp.asarray(s.t), jnp.asarray(s.balls_left))
    for _ in range(4):
        actions = rng.integers(0, 3, E).astype(np.int32)
        np.testing.assert_array_equal(port.render(s), np.asarray(jax.vmap(ref.render)(rs)))
        s, reward, done = port.step(s, actions)
        rs, r_reward, r_done = jax.vmap(ref.step)(rs, jnp.asarray(actions))
        for field in ("ball_x", "ball_y", "paddle_x", "t"):
            got, want = getattr(s, field), np.asarray(getattr(rs, field))
            assert got.dtype == want.dtype, field
            np.testing.assert_array_equal(got, want, err_msg=field)
        assert reward.dtype == np.asarray(r_reward).dtype
        np.testing.assert_array_equal(reward, np.asarray(r_reward))
        np.testing.assert_array_equal(done, np.asarray(r_done))
    np.testing.assert_array_equal(port.render(s), np.asarray(jax.vmap(ref.render)(rs)))


def test_catch_resets_stay_in_the_reference_ranges():
    env = CatchEnv(84, 84, **catch_params("memory_catch:5:3"))
    s = env.reset(np.random.default_rng(0), 4096)
    reach = max(2 * (84 - 2 - 5) * 3 - 4, 1)
    assert (s.ball_y == 0).all() and (s.t == 0).all()
    assert (0 <= s.ball_x).all() and (s.ball_x < 84).all()
    assert (np.abs(s.paddle_x - s.ball_x) <= reach).all()
    assert (0 <= s.paddle_x).all() and (s.paddle_x < 84).all()
    host = make_env(tiny_test().replace(env_name="catch"), seed=1)
    frame = host.reset()
    assert frame.shape == (12, 12, 1) and frame.dtype == np.uint8
    assert host.step(0)[0].shape == (12, 12, 1)


def _drive(actor, steps):
    for _ in range(steps):
        actor.step()


def test_actor_streams_match_reference():
    cfg = tiny_test().replace(env_name="catch", action_dim=3)
    jcfg = jax_tiny_test().replace(env_name="catch", action_dim=3)
    net, params = jax_init_params(jax.random.PRNGKey(0), jcfg)
    eps = epsilon_ladder(3, 0.4, 7.0)
    ref_blocks, port_blocks = [], []
    ref = RefActor(jcfg, net, RefParamStore(params), CatchVecEnv(3, 12, 12, seed=5), eps,
                   lambda *a: ref_blocks.append(a), seed=7)
    tnet = R2D2Network.from_config(cfg, device="cpu")
    tnet.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    port = VectorizedActor(cfg, R2D2Network.from_config(cfg, device="cpu"), ParamStore(tnet),
                           CatchVecEnv(3, 12, 12, seed=5), eps,
                           lambda *a: port_blocks.append(a), seed=7, device="cpu")
    _drive(ref, 45)
    _drive(port, 45)
    assert len(port_blocks) == len(ref_blocks) >= 9  # episodes end and blocks cut
    exact = ("obs", "last_action", "last_reward", "action", "n_step_reward", "gamma",
             "num_sequences", "burn_in_steps", "learning_steps", "forward_steps")
    for (pb, pp, pr), (rb, rp, rr) in zip(port_blocks, ref_blocks):
        for f in exact:
            np.testing.assert_array_equal(getattr(pb, f), getattr(rb, f), err_msg=f)
        np.testing.assert_allclose(pb.hidden, rb.hidden, atol=1e-5)
        np.testing.assert_allclose(pp, rp, rtol=1e-4, atol=1e-5)
        assert pr == rr
    np.testing.assert_array_equal(port.obs, ref.obs)
    np.testing.assert_allclose(port.carry[0].numpy(), np.asarray(ref.carry[0]), atol=1e-5)


def test_trainer_runs_inline_on_the_cpu():
    cfg = tiny_test().replace(env_name="catch", training_steps=10)
    lstm_kernel.reset_launch_counts()
    tr = train.Trainer(cfg, device="cpu")
    assert tr.cfg.action_dim == 3  # taken from the env
    tr.run_inline()
    m = tr.metrics()
    assert m["step"] == 10 and m["backward_arm"] == "default"
    assert np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
    assert m["replay_size"] >= cfg.learning_starts and m["episodes"] > 0
    # the learner published every publish_interval updates
    assert tr.param_store.version == 10 // cfg.publish_interval
    # CPU tensors never reach a kernel
    assert lstm_kernel.launch_counts == {"lstm_fwd": 0, "lstm_seq_bwd": 0}


def test_cli_runs_on_the_cpu_when_asked(capsys):
    train.main(["--preset", "tiny_test", "--env", "catch", "--steps", "2", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["step"] == 2 and out["device"] == "cpu" and np.isfinite(out["loss"])


def test_entry_points_refuse_to_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs a machine without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--preset", "tiny_test", "--env", "catch", "--steps", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.Trainer(tiny_test().replace(env_name="catch"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    cfg = tiny_test().replace(env_name="catch", action_dim=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        R2D2Network.from_config(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initial_carry(2, cfg.hidden_dim)
    net = R2D2Network.from_config(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VectorizedActor(cfg, net, ParamStore(net), CatchVecEnv(3, 12, 12, seed=5),
                        epsilon_ladder(3, 0.4, 7.0), lambda *a: None)


def test_unported_options_are_refused_by_name():
    with pytest.raises(NotImplementedError, match="M7"):
        train.Trainer(tiny_test().replace(env_name="catch", precision="bf16"), device="cpu")
    with pytest.raises(NotImplementedError, match="M7"):
        train.main(["--preset", "atari", "--env", "catch", "--steps", "1", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="M8"):
        train.Trainer(tiny_test().replace(env_name="catch", encoder="impala"), device="cpu")
