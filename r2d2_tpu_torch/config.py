"""Frozen dataclass configuration for the PyTorch port.

A copy of the fields of ``r2d2_tpu.config.R2D2Config`` that the ported
training loop reads, with the same names, defaults and ``validate()``
rules. The port keeps its own copy because importing the JAX package
loads JAX.

The port carries only the fields it reads. One documented difference:
the ``long_context`` preset leaves out the JAX preset's ``scan_chunk=64``,
the remat chunk of the JAX LSTM's scan backend, which the LRU core that
preset trains never reads.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class R2D2Config:
    # --- environment -----------------------------------------------------
    env_name: str = "MsPacman"
    # channels-last (NHWC) observations, as the JAX package stores them
    obs_shape: Tuple[int, ...] = (84, 84, 1)
    action_dim: int = 9
    max_episode_steps: int = 27000

    # --- optimization ----------------------------------------------------
    lr: float = 1e-4
    # "cosine" decays to lr*lr_final_frac over training_steps and holds
    lr_schedule: str = "constant"  # constant | cosine
    lr_final_frac: float = 0.1
    adam_eps: float = 1e-3
    grad_norm: float = 40.0
    batch_size: int = 64

    # --- RL --------------------------------------------------------------
    gamma: float = 0.997
    value_rescale_eps: float = 1e-3

    # --- prioritized replay ----------------------------------------------
    prio_exponent: float = 0.9
    is_exponent: float = 0.6
    # per-sequence priority = eta*max|td| + (1-eta)*mean|td|
    td_mix_eta: float = 0.9
    buffer_capacity: int = 2_000_000
    block_length: int = 400
    learning_starts: int = 50_000

    # --- sequence shape --------------------------------------------------
    burn_in_steps: int = 40
    learning_steps: int = 40
    forward_steps: int = 5
    # replayed sequences start from zero recurrent state (ablation)
    zero_state_replay: bool = False

    # --- schedule / cadences ---------------------------------------------
    training_steps: int = 100_000
    target_net_update_interval: int = 2000
    save_interval: int = 500
    # learner publishes weights to actors every N updates
    publish_interval: int = 4
    actor_update_interval: int = 400
    # seconds between metrics records (0.0: one record per update)
    log_interval: float = 10.0

    # --- actor fleet ------------------------------------------------------
    num_actors: int = 8
    # threaded mode: target ratio of learner-consumed to collected
    # transitions; below it the actor thread yields to the learner (0 =
    # free-running actors)
    samples_per_insert: float = 0.0
    base_eps: float = 0.4
    eps_alpha: float = 7.0
    test_epsilon: float = 0.001

    # --- network ----------------------------------------------------------
    hidden_dim: int = 512
    encoder: str = "nature"  # "nature" | "impala" | "mlp"
    # the impala encoder's channel stack, one residual stage per entry
    impala_channels: Tuple[int, ...] = (16, 32, 32)
    # extra Dense(latent)+relu layers after the latent projection
    encoder_depth: int = 0
    # named model-size preset (MODEL_PRESETS): "base" keeps the run
    # preset's own dims; applied as plain field overrides by
    # apply_model_preset() (train.py --model-preset)
    model_preset: str = "base"

    # --- numerics ---------------------------------------------------------
    compute_dtype: str = "float32"  # "float32" | "bfloat16"
    precision: str = "fp32"  # "fp32" | "bf16"

    # fused-sequence semantics: per-row stop-gradient seam at burn_in[b]
    fused_sequence: bool = True
    # explicit backward-arm knobs of the fused sequence unroll
    seq_fused_dwh: bool = False
    seq_grad_checkpoint: int = 0
    # "auto" | "default" | "fused_dwh" | "ckpt" (see resolve_backward_arm)
    backward_arm: str = "auto"
    backward_residual_budget_mb: int = 128
    # "auto": the hand-written kernels on a CUDA device, their plain
    # PyTorch versions on the CPU; "pallas" names the kernels, "scan" the
    # plain versions (refused on a CUDA device)
    lstm_backend: str = "auto"
    recurrent_core: str = "lstm"  # "lstm" | "lru"
    # lru only: > 0 unrolls through per-chunk causal triangular matmuls of
    # this many steps and a T/chunk carry scan instead of one associative
    # scan (the same recurrence summed in another order; models/lru.py)
    lru_chunk: int = 0
    # lru only: the eigenvalue ring |lambda| ~ U(r_min, r_max) at init
    lru_r_min: float = 0.9
    lru_r_max: float = 0.999

    # --- replay -----------------------------------------------------------
    # the C++ replay core (r2d2_tpu_torch/_native: sum tree and window
    # gathers, built with g++ at first use); a failed build raises. False
    # takes the numpy path
    use_native_replay: bool = True

    # --- infra ------------------------------------------------------------
    seed: int = 0
    # supervision (utils/supervision.py): restart budget per worker thread,
    # seconds of silent heartbeat before a stall is reported, and seconds
    # of stall that fail the run (0 disables)
    worker_max_restarts: int = 3
    heartbeat_timeout: float = 120.0
    stall_fatal_timeout: float = 900.0
    checkpoint_dir: str = "checkpoints"
    metrics_path: Optional[str] = None  # jsonl metrics file

    # --- derived ----------------------------------------------------------
    @property
    def resolved_compute_dtype(self) -> str:
        """The matmul and activation dtype of the model: precision="bf16"
        forces bfloat16, precision="fp32" defers to compute_dtype (the
        JAX package's rule)."""
        return "bfloat16" if self.precision == "bf16" else self.compute_dtype

    @property
    def torch_compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.resolved_compute_dtype)

    @property
    def carry_dtype(self) -> torch.dtype:
        """The dtype of the acting carry on the device: the LSTM's step runs
        in the compute dtype, the LRU's recurrence in float32 (its carry
        (Re h, Im h) is float32 whatever the compute dtype)."""
        return torch.float32 if self.recurrent_core == "lru" else self.torch_compute_dtype

    @property
    def state_dtype(self) -> torch.dtype:
        """The dtype of STORED recurrent carries (the replay hidden store,
        the actor's accumulators), with the JAX package's meaning: bfloat16
        under precision="bf16", else float32. numpy has no bfloat16, so the
        host keeps bf16 carries as their uint16 bit patterns
        (``replay.block.to_state_host`` / ``state_tensor``)."""
        return torch.bfloat16 if self.precision == "bf16" else torch.float32

    @property
    def seq_len(self) -> int:
        """burn_in + learning + forward = 85 at defaults."""
        return self.burn_in_steps + self.learning_steps + self.forward_steps

    @property
    def seqs_per_block(self) -> int:
        return self.block_length // self.learning_steps

    @property
    def num_blocks(self) -> int:
        return self.buffer_capacity // self.block_length

    @property
    def num_sequences(self) -> int:
        return self.buffer_capacity // self.learning_steps

    @property
    def block_slot_len(self) -> int:
        """Max stored steps per block incl. the leading burn-in context and
        the trailing +1 seed entry."""
        return self.block_length + self.burn_in_steps + 1

    def resolve_backward_arm(
        self, batch_size: Optional[int] = None, device: str = "cuda"
    ) -> Tuple[str, int]:
        """-> (arm, ckpt_stride), as ``r2d2_tpu.config.resolve_backward_arm``.

        ``lstm_backend="auto"`` resolves to the hand-written kernels for a
        CUDA device and to the plain versions for a CPU device, the way the
        JAX package resolves it to Pallas on a TPU and to scan elsewhere."""
        if self.seq_grad_checkpoint > 0:
            return ("ckpt", self.seq_grad_checkpoint)
        if self.seq_fused_dwh:
            return ("fused_dwh", 0)
        if (
            self.backward_arm == "default"
            or self.recurrent_core != "lstm"
            or not self.fused_sequence
        ):
            return ("default", 0)
        backend = self.lstm_backend
        if backend == "auto":
            backend = "pallas" if torch.device(device).type == "cuda" else "scan"
        if backend != "pallas":
            return ("default", 0)
        from r2d2_tpu_torch.ops.lstm_kernel import choose_backward_arm

        B = self.batch_size if batch_size is None else batch_size
        return choose_backward_arm(
            self.seq_len,
            max(B, 1),
            self.hidden_dim,
            self.resolved_compute_dtype,
            self.backward_residual_budget_mb * (1 << 20),
            mode=self.backward_arm,
        )

    def validate(self) -> "R2D2Config":
        if self.block_length % self.learning_steps != 0:
            raise ValueError("block_length must be a multiple of learning_steps")
        if self.buffer_capacity % self.block_length != 0:
            raise ValueError("buffer_capacity must be a multiple of block_length")
        if self.forward_steps < 1:
            raise ValueError("forward_steps must be >= 1")
        if self.action_dim > 256:
            raise ValueError("action_dim > 256 would overflow uint8 replay storage")
        if self.encoder not in ("nature", "impala", "mlp"):
            raise ValueError(f"unknown encoder {self.encoder!r}")
        if self.precision not in ("fp32", "bf16"):
            raise ValueError(f"unknown precision {self.precision!r}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown compute_dtype {self.compute_dtype!r}")
        if self.lstm_backend not in ("auto", "scan", "pallas"):
            raise ValueError(f"unknown lstm_backend {self.lstm_backend!r}")
        if self.recurrent_core not in ("lstm", "lru"):
            raise ValueError(f"unknown recurrent_core {self.recurrent_core!r}")
        if self.lru_chunk < 0:
            raise ValueError("lru_chunk must be >= 0")
        if self.lru_chunk > 0 and self.recurrent_core != "lru":
            raise ValueError(
                "lru_chunk is the LRU core's unroll formulation; set "
                "recurrent_core='lru' (or leave lru_chunk=0)"
            )
        if not 0.0 < self.lru_r_min <= self.lru_r_max < 1.0:
            raise ValueError(
                "lru eigenvalue ring needs 0 < lru_r_min <= lru_r_max < 1 "
                f"(|lambda| < 1 is the stability guarantee), got "
                f"[{self.lru_r_min}, {self.lru_r_max}]"
            )
        if self.lr_schedule not in ("constant", "cosine"):
            raise ValueError(f"unknown lr_schedule {self.lr_schedule!r}")
        if not 0.0 <= self.lr_final_frac <= 1.0:
            raise ValueError("lr_final_frac must be in [0, 1]")
        if self.recurrent_core == "lru" and self.lstm_backend == "pallas":
            raise ValueError(
                "lstm_backend='pallas' is the fused LSTM kernel; the lru "
                "core has none — use lstm_backend='auto'"
            )
        if self.seq_grad_checkpoint < 0:
            raise ValueError("seq_grad_checkpoint must be >= 0 (0 = off)")
        if self.seq_grad_checkpoint > 0:
            if self.seq_len % self.seq_grad_checkpoint != 0:
                raise ValueError(
                    f"seq_grad_checkpoint={self.seq_grad_checkpoint} must "
                    f"divide seq_len={self.seq_len}"
                )
            if self.seq_fused_dwh:
                raise ValueError(
                    "seq_fused_dwh and seq_grad_checkpoint are alternative "
                    "backward arms — set at most one"
                )
        if (self.seq_fused_dwh or self.seq_grad_checkpoint > 0) and (
            self.recurrent_core != "lstm"
        ):
            raise ValueError(
                "seq_fused_dwh / seq_grad_checkpoint require recurrent_core='lstm'"
            )
        if self.backward_arm not in ("auto", "default", "fused_dwh", "ckpt"):
            raise ValueError(f"unknown backward_arm {self.backward_arm!r}")
        if self.backward_residual_budget_mb < 1:
            raise ValueError("backward_residual_budget_mb must be >= 1")
        if (
            self.backward_arm in ("fused_dwh", "ckpt")
            and self.recurrent_core != "lstm"
        ):
            raise ValueError("backward_arm forces an LSTM kernel backward; "
                             "it requires recurrent_core='lstm'")
        if self.encoder_depth < 0:
            raise ValueError("encoder_depth must be >= 0 (extra latent layers)")
        if self.model_preset not in MODEL_PRESETS:
            raise ValueError(
                f"unknown model_preset {self.model_preset!r}; one of "
                f"{sorted(MODEL_PRESETS)} (config.MODEL_PRESETS)"
            )
        if self.env_name:
            self._validate_env_geometry(self.env_name, self.obs_shape)
        return self

    def _validate_env_geometry(self, env_name: str, obs_shape) -> None:
        """Episode cap vs catch geometry (the JAX package's rule for the
        catch family); other names pass through."""
        from r2d2_tpu_torch.envs.catch import catch_params, is_catch_name

        if is_catch_name(env_name):
            p = catch_params(env_name)
            need = (obs_shape[0] - 2) * p.get("fall_every", 1) * p.get("balls", 1)
            if self.max_episode_steps < need:
                raise ValueError(
                    f"max_episode_steps={self.max_episode_steps} truncates "
                    f"{env_name!r} at obs {obs_shape} before the last ball "
                    f"lands (needs >= {need}): every episode would end "
                    "reward-free"
                )

    def replace(self, **kw) -> "R2D2Config":
        return dataclasses.replace(self, **kw).validate()


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. A CUDA device that is not there
    raises: the port never carries on on the CPU unless asked to."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU unless "
            "the caller passes device='cpu' (--device cpu)"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def set_fp32_numerics() -> None:
    """Float32 sums on the card, as XLA takes them: cuBLAS matmuls are
    full fp32 by default, but cuDNN convolutions default to TF32 (about
    three decimal digits), so both switches are set off explicitly; and a
    bf16 matmul sums in f32 (XLA's preferred element type for bf16 dots),
    where cuBLAS may otherwise reduce split-K partials in bf16."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


# --------------------------------------------------------------------------
# Presets (the JAX package's `atari`, `long_context` and `tiny_test`)
# --------------------------------------------------------------------------


def default_atari(game: str = "MsPacman") -> R2D2Config:
    """The reference hyperparameters, with the JAX preset's bfloat16
    compute (f32 parameters, carries and loss math); ``--set
    compute_dtype=float32`` reproduces the reference's float32 numerics."""
    return R2D2Config(env_name=game, compute_dtype="bfloat16").validate()


def long_context(
    game: str = "memory_catch:10:8:4",
    obs_shape: tuple = (26, 26, 1),
) -> R2D2Config:
    """The seq_len=581 stored-state burn-in stretch (the JAX package's
    ``long_context``, BASELINE.json config 5): multi-ball slow-fall
    flashing-cue catch at 26x26 (768-step episodes of four balls), the
    IMPALA encoder with channels (8, 16), the LRU core at hidden 128,
    burn-in / learning / forward 64/512/5 in blocks of 1024, cosine lr,
    bf16 compute. For a catch-family name the episode cap is the catch
    geometry's: (rows - 2) x fall interval x balls. The JAX preset's
    ``scan_chunk=64`` is left out: it is the JAX LSTM scan backend's remat
    chunk, which the LRU core never reads."""
    from r2d2_tpu_torch.envs.catch import catch_params, is_catch_name

    kw = {}
    if is_catch_name(game):
        p = catch_params(game)
        kw = dict(
            action_dim=3,
            max_episode_steps=(obs_shape[0] - 2) * p.get("fall_every", 1) * p.get("balls", 1),
        )
    return R2D2Config(
        env_name=game,
        obs_shape=obs_shape,
        encoder="impala",
        impala_channels=(8, 16),
        hidden_dim=128,
        recurrent_core="lru",
        lr_schedule="cosine",
        burn_in_steps=64,
        learning_steps=512,
        forward_steps=5,
        block_length=1024,  # 2 learning windows per block
        buffer_capacity=2_048_000,  # 2000 blocks of 1024
        compute_dtype="bfloat16",
        **kw,
    ).validate()


def tiny_test() -> R2D2Config:
    """Minimal shapes for fast unit/integration tests."""
    return R2D2Config(
        obs_shape=(12, 12, 1),
        action_dim=4,
        hidden_dim=32,
        batch_size=8,
        burn_in_steps=4,
        learning_steps=4,
        forward_steps=2,
        block_length=16,
        buffer_capacity=640,
        learning_starts=64,
        num_actors=2,
        training_steps=50,
        target_net_update_interval=10,
        save_interval=25,
        max_episode_steps=100,
        encoder="mlp",
        # 0.0 = one metrics record per update
        log_interval=0.0,
    ).validate()


PRESETS = {
    "atari": default_atari,
    "long_context": long_context,
    "tiny_test": tiny_test,
}


# --------------------------------------------------------------------------
# Model-size presets (the JAX package's MODEL_PRESETS): orthogonal to the run
# PRESETS above — a run preset fixes the task and replay geometry, a model
# preset scales the net within it, as plain field overrides
# --------------------------------------------------------------------------

MODEL_PRESETS = {
    # the dims of whatever run preset is active
    "base": {},
    # wider LSTM/latent: 4x the core matmul FLOPs/bytes of hidden 512
    "wide": {"hidden_dim": 1024},
    # 2048-wide core: ~16x the base core
    "xl": {"hidden_dim": 2048},
    # deeper encoder at base width: 2 extra latent layers
    "deep": {"encoder_depth": 2},
    # wide core + deeper trunk
    "deep_wide": {"hidden_dim": 1024, "encoder_depth": 2},
}


def apply_model_preset(cfg: R2D2Config, name: Optional[str] = None) -> R2D2Config:
    """Overlay a MODEL_PRESETS entry onto `cfg` (default: its own
    cfg.model_preset field) and stamp the name, re-validating."""
    name = cfg.model_preset if name is None else name
    if name not in MODEL_PRESETS:
        raise ValueError(
            f"unknown model_preset {name!r}; one of {sorted(MODEL_PRESETS)}"
        )
    return cfg.replace(model_preset=name, **MODEL_PRESETS[name])


def parse_overrides(pairs) -> dict:
    """Parse CLI `--set key=value` pairs into typed replace() kwargs,
    coerced by the dataclass field's type."""
    fields = {f.name: f for f in dataclasses.fields(R2D2Config)}
    out = {}
    for pair in pairs:
        if "=" not in pair:
            raise ValueError(f"--set expects key=value, got {pair!r}")
        key, _, raw = pair.partition("=")
        key = key.strip()
        if key not in fields:
            raise ValueError(f"unknown config field {key!r}; valid: {sorted(fields)}")
        ftype = fields[key].type
        if isinstance(ftype, str) and ftype.startswith("Optional["):
            if raw.lower() == "none":
                out[key] = None
                continue
            ftype = ftype[len("Optional[") : -1]
        if ftype in ("int", int):
            out[key] = int(raw)
        elif ftype in ("float", float):
            out[key] = float(raw)
        elif ftype in ("bool", bool):
            if raw.lower() not in ("true", "false", "1", "0"):
                raise ValueError(f"{key} expects a bool, got {raw!r}")
            out[key] = raw.lower() in ("true", "1")
        elif "Tuple" in str(ftype):
            out[key] = tuple(int(v) for v in raw.split(","))
        else:
            out[key] = raw
    return out
