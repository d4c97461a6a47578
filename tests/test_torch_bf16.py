"""The port under bfloat16 compute against the JAX package's bf16 path.

The same numpy-seeded inputs go through both packages. The JAX side runs the
Pallas kernels in interpret mode; the port runs the plain versions of its
kernels (on the CPU a wrapper takes its plain version), which repeat the
bf16 forms' casts: products of bf16 values summed in float32, float32 carries,
outs (and K5's dz) rounded to the proj dtype.

Tolerances. The ceiling is the JAX package's own bf16 class
(tests/test_pallas_lstm.py: forward atol 3e-2, gradient relative L2 < 0.05);
where the casts match, tighter:
- the kernels' plain versions against the Pallas kernels on the same bf16
  operands: outs within one bf16 ulp below 1 (2^-8; a float32 sum in
  another order can round to the neighbouring value), the float32 outputs
  (cs, dz, dWh) to rtol 1e-3 / atol 1e-4;
- the LSTM module (the bf16 input projection in each framework's own bf16
  matmul, then the unroll): outs to one bf16 ulp at their magnitude,
  2^-7, and gradients to relative L2 1e-2;
- one train step, R2D2 network and all: loss and priorities to rtol 1e-2 /
  atol 1e-3, the updated parameters to the float32 tolerance (Adam's
  update is close to scale-free, so a 1e-2 relative gradient error moves a
  parameter by about 1e-2 x lr);
- the bf16 hidden store: bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2_tpu import config as jax_config
from r2d2_tpu.learner import DeviceBatch as JaxBatch
from r2d2_tpu.learner import init_train_state as jax_init_train_state
from r2d2_tpu.learner import make_train_step as jax_make_train_step
from r2d2_tpu.models.lstm import LSTM as JaxLSTM
from r2d2_tpu.models.r2d2 import init_params as jax_init_params
from r2d2_tpu.ops import pallas_lstm as ref
from r2d2_tpu.replay.accumulator import SequenceAccumulator as RefAccumulator
from r2d2_tpu.replay.replay_buffer import ReplayBuffer as RefReplay
from r2d2_tpu_torch import config as port_config
from r2d2_tpu_torch import train
from r2d2_tpu_torch.interop import params_from_flax, params_to_flax
from r2d2_tpu_torch.learner import DeviceBatch, TrainState, make_optimizer, make_train_step
from r2d2_tpu_torch.models.lstm import LSTM
from r2d2_tpu_torch.models.r2d2 import R2D2Network
from r2d2_tpu_torch.ops import lstm_kernel as port
from r2d2_tpu_torch.replay.accumulator import SequenceAccumulator
from r2d2_tpu_torch.replay.block import state_tensor, to_state_host
from r2d2_tpu_torch.replay.replay_buffer import ReplayBuffer

torch.set_num_threads(1)

BF16 = torch.bfloat16
ULP = 2.0 ** -8  # one bf16 ulp in [0.5, 1)
T, B, H = 7, 5, 32
BURNS = {
    "zero": np.zeros(B, np.int32),
    "mid": np.full(B, T // 2, np.int32),
    "last": np.full(B, T - 1, np.int32),
    "mixed": np.array([0, 3, T - 1, 1, 5], np.int32),
}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _bf16_operands(seed):
    """proj, wh, h0, c0 rounded to bf16 (as float32 numpy) and the f32
    cotangents, from one numpy stream."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    rb = lambda x: np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    return (rb(f(T, B, 4 * H)), rb(f(H, 4 * H) / np.sqrt(H)), rb(f(B, H) * 0.3),
            rb(f(B, H) * 0.3), f(T, B, H), f(B, H))


def _j(x, bf16=True):
    return jnp.asarray(x).astype(jnp.bfloat16 if bf16 else jnp.float32)


def _t(x, bf16=True):
    t = torch.from_numpy(np.array(x, np.float32))
    return t.to(BF16) if bf16 else t


def _f32(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) else x.float().numpy()


# --------------------------------------------------------------------------
# the kernels' plain versions against the Pallas kernels, bf16 operands
# --------------------------------------------------------------------------


def _forward(seed):
    proj, wh, h0, c0, dout, dcT = _bf16_operands(seed)
    j = ref._lstm_fwd_call(_j(proj), _j(wh), _j(h0), _j(c0), interpret=True)
    p = port.lstm_fwd(_t(proj), _t(wh), _t(h0), _t(c0))
    return (proj, wh, h0, c0, dout, dcT), j, p


def test_plain_forward_bf16_matches_pallas():
    _, (j_outs, j_cs), (p_outs, p_cs) = _forward(0)
    assert p_outs.dtype == BF16 and p_cs.dtype == torch.float32
    np.testing.assert_allclose(_f32(p_outs), _f32(j_outs), rtol=0, atol=ULP)
    np.testing.assert_allclose(p_cs.numpy(), np.asarray(j_cs), rtol=1e-3, atol=1e-4)


def _walk_operands(seed):
    """The reverse walks' operands on the Pallas forward's bf16 residuals:
    (dout, proj, hprev, cprev, cs, wh, dcT) as numpy float32."""
    (proj, wh, h0, c0, dout, dcT), (outs, cs), _ = _forward(seed)
    hprev = np.concatenate([h0[None], _f32(outs)[:-1]])
    cprev = np.concatenate([c0[None], np.asarray(cs)[:-1]])
    return dout, proj, hprev, cprev, np.asarray(cs), wh, dcT


def _jax_walk(dout, proj, hprev, cprev, cs, wh, dcT):
    return (_j(dout, False), _j(proj), _j(hprev), _j(cprev, False), _j(cs, False), _j(wh),
            _j(dcT, False))


def _port_walk(dout, proj, hprev, cprev, cs, wh, dcT):
    return (_t(dout, False), _t(proj), _t(hprev), _t(cprev, False), _t(cs, False), _t(wh),
            _t(dcT, False))


@pytest.mark.parametrize("burn_name", sorted(BURNS))
def test_plain_seq_backward_bf16_matches_pallas(burn_name):
    """K2 on the same residuals: bf16 proj, hprev, wh; f32 dz out."""
    burn = BURNS[burn_name]
    walk = _walk_operands(1)
    j_dz = ref._lstm_seq_bwd_call(*_jax_walk(*walk), jnp.asarray(burn.reshape(B, 1)),
                                  interpret=True)
    p_dz = port.lstm_seq_bwd(*_port_walk(*walk), torch.from_numpy(burn))
    assert p_dz.dtype == torch.float32
    np.testing.assert_allclose(p_dz.numpy(), np.asarray(j_dz), rtol=1e-3, atol=1e-4)
    for b in range(B):
        assert not p_dz[: burn[b], b].any()


@pytest.mark.parametrize("S", [1, 7])
@pytest.mark.parametrize("burn_name", ["zero", "mixed"])
def test_plain_ckpt_backward_bf16_matches_pallas(S, burn_name):
    """K5 from bf16 h checkpoints and f32 c checkpoints: dz in bf16, dWh
    summed from the f32 dz."""
    burn = BURNS[burn_name]
    (proj, wh, h0, c0, dout, dcT), (outs, cs), _ = _forward(2)
    h_ckpt = np.concatenate([h0[None], _f32(outs)[S - 1 : T - 1 : S]])
    c_ckpt = np.concatenate([c0[None], np.asarray(cs)[S - 1 : T - 1 : S]])
    j_dz, j_dwh = ref._lstm_seq_bwd_ckpt_call(
        _j(dout, False), _j(proj), _j(h_ckpt), _j(c_ckpt, False), _j(wh), _j(dcT, False),
        jnp.asarray(burn.reshape(B, 1)), S=S, interpret=True)
    p_dz, p_dwh = port.lstm_seq_bwd_ckpt(
        _t(dout, False), _t(proj), _t(h_ckpt), _t(c_ckpt, False), _t(wh), _t(dcT, False),
        torch.from_numpy(burn), S)
    assert p_dz.dtype == BF16 and p_dwh.dtype == torch.float32
    np.testing.assert_allclose(_f32(p_dz), _f32(j_dz), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(p_dwh.numpy(), np.asarray(j_dwh), rtol=1e-3, atol=1e-4)


def test_plain_seamless_backward_bf16_matches_pallas():
    """K3 on bf16 proj, hprev, wh: dz, dh0 and dc0 out in f32."""
    walk = _walk_operands(4)
    j = ref._lstm_bwd_call(*_jax_walk(*walk), interpret=True)
    p = port.lstm_bwd(*_port_walk(*walk))
    for name, a, b in zip(("dz", "dh0", "dc0"), p, j):
        assert a.dtype == torch.float32, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("burn_name", sorted(BURNS))
def test_plain_fused_dwh_backward_bf16_matches_pallas(burn_name):
    """K4 on bf16 proj, hprev, wh: dz in bf16, exactly zero below each
    row's seam, and dWh summed in f32 from the unrounded dz."""
    burn = BURNS[burn_name]
    walk = _walk_operands(5)
    j_dz, j_dwh = ref._lstm_seq_bwd_fused_call(
        *_jax_walk(*walk), jnp.asarray(burn.reshape(B, 1)), interpret=True)
    p_dz, p_dwh = port.lstm_seq_bwd_fused(*_port_walk(*walk), torch.from_numpy(burn))
    assert p_dz.dtype == BF16 and p_dwh.dtype == torch.float32
    np.testing.assert_allclose(_f32(p_dz), _f32(j_dz), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(p_dwh.numpy(), np.asarray(j_dwh), rtol=1e-3, atol=1e-4)
    for b in range(B):
        assert not p_dz[: burn[b], b].any()


def test_fused_dwh_bf16_window_does_not_grow_with_T():
    """K4's bf16 form keeps W = min(5, T) steps of dz's bf16 low plane for
    its dWh pass (the dz output is the high plane), never a (T, B, 4H)
    float32 copy; its float32 form needs none."""
    for T_, B_, H_ in ((85, 96, 1024), (850, 96, 1024), (3, 4, 8)):
        window, W = port.fused_dwh_window(T_, B_, H_, BF16, "cpu")
        assert W == min(port.DWH_WINDOW, T_) and window.dtype == BF16
        assert tuple(window.shape) == (W, B_, 4 * H_)
    assert port.fused_dwh_window(85, 96, 1024, BF16, "cpu")[0].nbytes == 5 * 96 * 4096 * 2
    assert port.fused_dwh_window(85, 96, 1024, torch.float32, "cpu") == (None, 0)


def test_wrappers_take_bf16_where_pallas_does_and_refuse_the_rest():
    """On the CPU too: proj, wh and h0/c0, hprev or h_ckpt in bf16, for
    every kernel; a bf16 operand where the Pallas kernels take f32
    raises."""
    (proj, wh, h0, c0, dout, dcT), (outs, cs), _ = _forward(3)
    hprev = np.concatenate([h0[None], _f32(outs)[:-1]])
    walk = [_t(dout, False), _t(proj), _t(hprev), _t(hprev, False), _t(cs, False), _t(wh),
            _t(dcT, False)]
    burn = torch.from_numpy(BURNS["mixed"])
    port.lstm_seq_bwd(*walk, burn)
    port.lstm_bwd(*walk)
    port.lstm_seq_bwd_fused(*walk, burn)
    for i, name in ((0, "dout"), (3, "cprev"), (4, "cs"), (6, "dcT")):
        bad = list(walk)
        bad[i] = bad[i].to(BF16)
        with pytest.raises(TypeError, match=name):
            port.lstm_seq_bwd(*bad, burn)
        with pytest.raises(TypeError, match=name):
            port.lstm_bwd(*bad)
        with pytest.raises(TypeError, match=name):
            port.lstm_seq_bwd_fused(*bad, burn)
    with pytest.raises(TypeError, match="wh"):
        port.lstm_fwd(_t(proj), _t(wh, False), _t(h0), _t(c0))
    with pytest.raises(TypeError, match="c0"):
        port.lstm_fwd(_t(proj), _t(wh), _t(h0), _t(c0, False))
    with pytest.raises(TypeError, match="hprev"):
        port.lstm_bwd(walk[0], walk[1], walk[3], *walk[3:])
    with pytest.raises(TypeError, match="float16"):
        port.lstm_fwd(_t(proj).half(), _t(wh).half(), _t(h0).half(), _t(c0).half())
    with pytest.raises(TypeError, match="c_ckpt"):
        port.lstm_seq_bwd_ckpt(walk[0], walk[1], _t(h0[None]), _t(c0[None]), walk[5],
                               walk[6], burn, T)


# --------------------------------------------------------------------------
# the bf16 LSTM module, through interop-shared parameters
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arm", ["default", "ckpt", "fused_dwh", "no_seam"])
def test_bf16_lstm_module_matches_flax(arm):
    """The module casts xs, wi, wh, b and the carry to bf16, projects in
    bf16 and unrolls through K1 and K2 (K5 at S=3, K4, or with no seam
    K3); values and the f32 gradients (the parameters', and with no seam
    the initial carry's) against the flax module with backend="pallas"."""
    Bm, Tm, D, Hm = 8, 6, 24, 32
    kw = dict(hidden_dim=Hm, in_dim=D, dtype=jnp.bfloat16, backend="pallas")
    jmod = JaxLSTM(**kw, grad_checkpoint=3 if arm == "ckpt" else 0,
                   fused_dwh=arm == "fused_dwh")
    rng = np.random.default_rng(15)
    xs = rng.normal(size=(Bm, Tm, D)).astype(np.float32)
    carry = [(rng.normal(size=(Bm, Hm)) * 0.2).astype(np.float32) for _ in range(2)]
    burn = None if arm == "no_seam" else np.array([0, 1, 2, 3, 5, 4, 0, 2], np.int32)
    params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(xs), tuple(map(jnp.asarray, carry)))
    pmod = LSTM(Hm, D, backward_arm={"ckpt": ("ckpt", 3), "fused_dwh": ("fused_dwh", 0)}.get(
        arm, ("default", 0)), dtype=BF16)
    pmod.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                          _np_tree(params)["params"].items()})

    def jloss(p, carry):
        outs, (hT, cT) = jmod.apply(p, jnp.asarray(xs), carry,
                                    burn_in=None if burn is None else jnp.asarray(burn))
        return jnp.sum(jnp.tanh(outs.astype(jnp.float32))), (outs, hT, cT)

    (_, (j_outs, j_hT, j_cT)), (j_grads, j_dcarry) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, tuple(map(jnp.asarray, carry)))
    p_carry = tuple(torch.from_numpy(c).requires_grad_(True) for c in carry)
    p_outs, (p_hT, p_cT) = pmod(torch.from_numpy(xs), p_carry,
                                None if burn is None else torch.from_numpy(burn))
    assert p_outs.dtype == p_hT.dtype == p_cT.dtype == BF16
    torch.sum(torch.tanh(p_outs.float())).backward()
    if arm == "no_seam":  # the gradient runs into the initial carry
        for name, pc, jc in zip(("d h0", "d c0"), p_carry, j_dcarry):
            jc = np.asarray(jc)
            rel = np.linalg.norm(pc.grad.numpy() - jc) / (np.linalg.norm(jc) + 1e-6)
            assert pc.grad.dtype == torch.float32 and rel < 1e-2, (name, rel)
    np.testing.assert_allclose(_f32(p_outs.detach()), _f32(j_outs), rtol=0, atol=2 * ULP)
    np.testing.assert_allclose(_f32(p_hT.detach()), _f32(j_hT), rtol=0, atol=2 * ULP)
    np.testing.assert_allclose(_f32(p_cT.detach()), _f32(j_cT), rtol=2 * ULP, atol=2 * ULP)
    for name, jg in _np_tree(j_grads)["params"].items():
        pg = getattr(pmod, name).grad.numpy()
        assert pg.dtype == np.float32
        rel = np.linalg.norm(pg - jg) / (np.linalg.norm(jg) + 1e-6)
        assert rel < 1e-2, (name, rel)


# --------------------------------------------------------------------------
# the network and one train step
# --------------------------------------------------------------------------


def _cfgs(**kw):
    jcfg = jax_config.tiny_test().replace(lstm_backend="pallas", precision="bf16", **kw)
    cfg = port_config.tiny_test().replace(lstm_backend="pallas", precision="bf16", **kw)
    return jcfg, cfg


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    Bn, Tn, L = cfg.batch_size, cfg.seq_len, cfg.learning_steps
    burn = rng.choice([0, 2, cfg.burn_in_steps], size=Bn).astype(np.int32)
    learn = np.full(Bn, L, np.int32)
    fwd = np.minimum(Tn - burn - learn, cfg.forward_steps).astype(np.int32)
    hidden = (rng.normal(size=(Bn, 2, cfg.hidden_dim)) * 0.5).astype(np.float32)
    return dict(
        obs=rng.integers(0, 256, size=(Bn, Tn, *cfg.obs_shape), dtype=np.uint8),
        last_action=rng.integers(0, cfg.action_dim, size=(Bn, Tn)).astype(np.int32),
        last_reward=rng.normal(size=(Bn, Tn)).astype(np.float32),
        hidden=hidden,
        action=rng.integers(0, cfg.action_dim, size=(Bn, L)).astype(np.int32),
        n_step_reward=rng.normal(size=(Bn, L)).astype(np.float32),
        gamma=np.full((Bn, L), cfg.gamma ** cfg.forward_steps, np.float32),
        burn_in_steps=burn, learning_steps=learn, forward_steps=fwd,
        is_weights=rng.uniform(0.3, 1.0, size=Bn).astype(np.float32),
    )


class _Sampled:
    task = None

    def __init__(self, d):
        self.__dict__.update(d)


def test_bf16_act_matches_flax():
    """The acting step in bf16 (core, carry), the dueling head in f32."""
    jcfg, cfg = _cfgs(encoder="nature", obs_shape=(36, 36, 1))
    net, params = jax_init_params(jax.random.PRNGKey(0), jcfg)
    tnet = R2D2Network.from_config(cfg, device="cpu")
    tnet.load_state_dict(params_from_flax(_np_tree(params)))
    rng = np.random.default_rng(1)
    E = 5
    obs = rng.integers(0, 256, size=(E, *cfg.obs_shape), dtype=np.uint8)
    la = rng.integers(0, cfg.action_dim, size=E).astype(np.int32)
    lr = rng.normal(size=E).astype(np.float32)
    h, c = (rng.normal(size=(2, E, cfg.hidden_dim)) * 0.5).astype(np.float32)
    jq, (jh, jc) = net.apply(params, jnp.asarray(obs), jnp.asarray(la), jnp.asarray(lr),
                             (jnp.asarray(h), jnp.asarray(c)), method=net.act)
    with torch.no_grad():
        tq, (th, tc) = tnet.act(torch.from_numpy(obs), torch.from_numpy(la),
                                torch.from_numpy(lr), (torch.from_numpy(h), torch.from_numpy(c)))
    assert tq.dtype == torch.float32 and th.dtype == tc.dtype == BF16
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(_f32(th), _f32(jh), rtol=0, atol=2 * ULP)
    np.testing.assert_allclose(_f32(tc), _f32(jc), rtol=2 * ULP, atol=2 * ULP)


@pytest.mark.parametrize("extra", [{}, {"encoder": "nature", "obs_shape": (36, 36, 1)},
                                   {"seq_grad_checkpoint": 2}, {"backward_arm": "fused_dwh"},
                                   {"fused_sequence": False}, {"hidden_dim": 36}],
                         ids=["mlp", "nature", "ckpt", "fused_dwh", "no_seam", "hidden36"])
def test_bf16_train_step_matches_jax(extra):
    """One update in bf16 from one converted TrainState on one batch whose
    carries are stored in bf16 (precision="bf16"): loss, priorities and
    every updated parameter."""
    jcfg, cfg = _cfgs(target_net_update_interval=2, **extra)
    assert cfg.resolve_backward_arm(device="cpu") == jcfg.resolve_backward_arm()
    net, jstate = jax_init_train_state(jcfg, jax.random.PRNGKey(0))
    jstep = jax_make_train_step(jcfg, net, donate=False)
    nets = []
    for _ in range(2):
        tnet = R2D2Network.from_config(cfg, device="cpu")
        tnet.load_state_dict(params_from_flax(_np_tree(jstate.params)))
        nets.append(tnet)
    nets[1].requires_grad_(False)
    pstate = TrainState(nets[0], nets[1], make_optimizer(cfg, nets[0].parameters()), 0)
    b = _batch(cfg, seed=10)
    jb = dict(b, hidden=np.asarray(jnp.asarray(b["hidden"]).astype(jnp.bfloat16)))
    pb = dict(b, hidden=to_state_host(b["hidden"], cfg.state_dtype))
    jstate, jm, jprio = jstep(jstate, JaxBatch.from_sampled(_Sampled(jb)))
    dev_batch = DeviceBatch.from_sampled(_Sampled(pb), "cpu")
    assert dev_batch.hidden.dtype == BF16
    pstate, pm, pprio = make_train_step(cfg)(pstate, dev_batch)
    for k in ("loss", "q_mean", "target_mean", "td_abs_mean"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-2, atol=1e-3, err_msg=k)
    assert pprio.dtype == torch.float32
    np.testing.assert_allclose(pprio.numpy(), np.asarray(jprio), rtol=1e-2, atol=1e-3)
    flat_j = jax.tree_util.tree_flatten_with_path(_np_tree(jstate.params))[0]
    flat_t = dict(jax.tree_util.tree_flatten_with_path(params_to_flax(pstate.net))[0])
    for path, v in flat_j:
        np.testing.assert_allclose(flat_t[path], v, rtol=1e-4, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))


def test_bf16_trainer_runs_on_the_cpu():
    """--set precision=bf16 trains (CPU, plain versions): finite loss, the
    replay's carries stored as bf16 bits, the actor's carry in bf16."""
    tr = train.Trainer(port_config.tiny_test().replace(env_name="catch", precision="bf16",
                                                       training_steps=3), device="cpu")
    tr.run_inline()
    m = tr.metrics()
    assert m["step"] == 3 and np.isfinite(m["loss"]) and m["compute_dtype"] == "bfloat16"
    assert tr.replay.hidden_store.dtype == np.uint16
    assert tr.actor.carry[0].dtype == BF16
    assert tr.state.net.core.wh.dtype == torch.float32  # the master copies stay f32


# --------------------------------------------------------------------------
# the bf16 hidden store
# --------------------------------------------------------------------------


def test_bf16_hidden_store_bits_match_jax():
    """The same transition stream, carries made from a float32 stream,
    through both accumulators and replay buffers under precision="bf16":
    the stored carries and the sampled ones are the JAX package's
    ml_dtypes bfloat16 bits, and the device batch's carry is their bf16."""
    jcfg = jax_config.tiny_test().replace(precision="bf16", use_native_replay=False)
    cfg = port_config.tiny_test().replace(precision="bf16")
    assert cfg.state_dtype == BF16 and jcfg.state_dtype.name == "bfloat16"
    rng = np.random.default_rng(0)
    accs = (RefAccumulator(jcfg), SequenceAccumulator(cfg))
    bufs = (RefReplay(jcfg), ReplayBuffer(cfg))
    for _ in range(12):
        length = int(rng.choice([3, cfg.learning_steps, 11, cfg.block_length]))
        first = rng.integers(0, 256, size=cfg.obs_shape, dtype=np.uint8)
        steps = [(int(rng.integers(cfg.action_dim)), float(rng.choice([0.0, 1.0])),
                  rng.integers(0, 256, size=cfg.obs_shape, dtype=np.uint8),
                  rng.normal(size=cfg.action_dim).astype(np.float32),
                  rng.normal(size=(2, cfg.hidden_dim)).astype(np.float32))
                 for _ in range(length)]
        for acc, buf in zip(accs, bufs):
            acc.reset(first)
            for step in steps:
                acc.add(*step)
            buf.add_block(*acc.finish(last_qval=None))
    ref_bits = bufs[0].hidden_store.view(np.uint16)
    assert bufs[1].hidden_store.dtype == np.uint16
    np.testing.assert_array_equal(bufs[1].hidden_store, ref_bits)
    s_ref = bufs[0].sample_batch(np.random.default_rng(5))
    s_port = bufs[1].sample_batch(np.random.default_rng(5))
    np.testing.assert_array_equal(s_port.hidden, s_ref.hidden.view(np.uint16))
    dev = DeviceBatch.from_sampled(s_port, "cpu").hidden
    assert dev.dtype == BF16
    np.testing.assert_array_equal(dev.float().numpy(), s_ref.hidden.astype(np.float32))
    # round trip through the host storage, and the float32 state's no-op
    np.testing.assert_array_equal(to_state_host(state_tensor(s_port.hidden), BF16),
                                  s_port.hidden)
    f32 = rng.normal(size=(3, 2, 4)).astype(np.float32)
    np.testing.assert_array_equal(to_state_host(f32, torch.float32), f32)
    with pytest.raises(TypeError, match="bf16 bits"):
        to_state_host(s_port.hidden, torch.float32)


# --------------------------------------------------------------------------
# the backward arm, resolved from the compute dtype
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,model_preset,batch,want", [
    ("bfloat16", "base", 64, ("default", 0)), ("bfloat16", "xl", 64, ("ckpt", 5)),
    ("float32", "base", 64, ("default", 0)), ("float32", "xl", 64, ("ckpt", 85)),
    ("bfloat16", "wide", 96, ("fused_dwh", 0)), ("bfloat16", "base", 192, ("fused_dwh", 0)),
    ("float32", "wide", 96, ("ckpt", 85)), ("float32", "base", 192, ("ckpt", 85)),
])
def test_backward_arm_resolves_from_the_compute_dtype(dtype, model_preset, batch, want):
    """The atari preset and its model presets at the default 128 MiB
    budget: under bf16 the carries shrink and the dz of the fused arms is
    bf16, so xl takes the checkpointed arm at stride 5 (13.4 MB of
    checkpoints + 89 MB of dz), not 85, and wide at batch 96 (or the base
    model at 192) the fused-dWh arm (50.1 MB of carries + 66.8 MB of bf16
    dz, where the default arm's f32 dz alone is 133.7 MB); the card
    resolves as the JAX package on a TPU, and the port trains each."""
    cfg = port_config.apply_model_preset(port_config.default_atari(), model_preset).replace(
        compute_dtype=dtype, batch_size=batch)
    jcfg = jax_config.apply_model_preset(jax_config.default_atari(), model_preset).replace(
        compute_dtype=dtype, lstm_backend="pallas", batch_size=batch)
    budget = cfg.backward_residual_budget_mb << 20
    assert cfg.resolve_backward_arm(device="cuda") == jcfg.resolve_backward_arm() == want
    assert port.choose_backward_arm(cfg.seq_len, cfg.batch_size, cfg.hidden_dim, dtype,
                                    budget) == ref.choose_backward_arm(
        cfg.seq_len, cfg.batch_size, cfg.hidden_dim, jnp.dtype(dtype), budget) == want
