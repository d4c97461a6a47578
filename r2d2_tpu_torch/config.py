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
    noop_max: int = 30  # reference environment.py:9

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

    # --- multi-task plane (multitask/) ------------------------------------
    # num_tasks = 1 is the single-task path: no task field in replay, no
    # task input to the network, no head widening. > 1 widens the dueling
    # head by a one-hot task embedding, stamps each block's task through
    # replay and passes it through the train step.
    num_tasks: int = 1
    # env name per task id (the registry order); empty outside multi-task
    multitask_envs: Tuple[str, ...] = ()
    # native action count per task; action_dim is the union width, and a
    # task's invalid tail is masked out of the dueling head. Empty = every
    # task uses the full union.
    task_action_dims: Tuple[int, ...] = ()
    # per-task discounts (the gamma ladder), read only by collection: they
    # travel through the stored per-step gamma. Empty = cfg.gamma for all.
    task_gammas: Tuple[float, ...] = ()

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
    # host env pools: > 0 steps the E envs across a persistent thread pool
    # of this size (ThreadedHostEnvPool — emulators release the GIL, so a
    # many-core host parallelizes them; the reference used 8 processes).
    # 0 = serial loop. Ignored by the tensor vec envs (already batched).
    env_pool_workers: int = 0
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
    # replay data plane: "host" (numpy store, one batch shipped per update),
    # "tiered" (the full-capacity host store with K batches gathered into
    # a pinned ring and copied on a side stream into one of two device
    # slabs while the learner's K-update dispatch consumes the other;
    # replay/tiered_store.py), "device" (the store on the card, an update
    # shipping only its sample coordinates and gathering its windows in the
    # step; replay/device_store.py), "sharded" (dp_size device stores, one
    # per shard of the mesh, each shard gathering and differentiating its
    # batch_size/dp rows; replay/sharded_store.py) or "multihost" (the
    # sharded plane across processes, each owning its local shards, the
    # gradients summed over torch.distributed; replay/multihost_store.py)
    replay_plane: str = "host"
    # experience collection: "host" (VectorizedActor, env stepped on the
    # host) or "device" (collect.DeviceCollector: policy, env dynamics and
    # block packing on the card; needs a tensor env core and the device
    # replay plane)
    collector: str = "host"
    # learner updates per dispatch (tiered and device planes): K staged
    # batches (learner.make_stacked_batch_train_step) or K coordinate sets
    # gathered from the device store (learner.make_fused_multi_train_step)
    updates_per_dispatch: int = 1
    # where the prioritized sum tree lives: "host" (the float64 tree, draws
    # and write-backs on the host) or "device" (the float32 tree on the
    # card, replay/device_sum_tree.py: sampling, IS weights and write-back
    # inside the learner's dispatch; device replay plane only)
    priority_plane: str = "host"
    # priority_plane="device" only: N dispatches of K updates in one
    # superstep (megastep.make_priority_superstep); the host re-enters
    # every N*K updates
    superstep_dispatches: int = 1
    # tiered plane only: stage chunks synchronously on the consumer thread
    # instead of the prefetch pipeline; no staging-thread RNG race with the
    # priority write-backs, so the sampling stream is bit-reproducible
    # (the resume contract), at the cost of the pipeline's overlap
    deterministic_staging: bool = False
    # the disk tier below the tiered plane's host slab (replay/disk_tier.py):
    # capacity in transitions (0 = off, a multiple of block_length), its
    # segment files' directory, and the block codec of its records
    # ("none" or "delta-zlib", replay/codec.py)
    replay_disk_dir: str = ""
    replay_disk_capacity: int = 0
    block_codec: str = "none"

    # --- parallelism ------------------------------------------------------
    # data-parallel shards of the learner batch (parallel/mesh.py): each of
    # dp_size shards takes batch_size/dp rows, and the gradients are summed
    # over the shards before one clipped Adam step. On the host, tiered and
    # device planes the batch is split; the sharded and multihost planes
    # keep one store per shard. On the multihost plane dp_size <= 1 means every
    # shard of every process
    dp_size: int = 1
    # tensor parallelism (models/tp.py): > 1 splits the latent Dense_0, the
    # LSTM's 4H gate columns and the dueling hiddens into tp contiguous
    # column slices and the head outs into row slices, one per member of a
    # batch shard's tp group (parallel/sharding_map.py's table)
    tp_size: int = 1
    # the fsdp mesh axis: > 1 shards the Adam moments over it (each
    # moment's first divisible dim still unsharded); under
    # partitioning="manual" the batch also splits over it and each member's
    # gradient lands on its moment shard (ZeRO-2)
    fsdp_size: int = 1
    # "gspmd": the batch over dp, whole parameters for the gradients, the
    # moments over fsdp (ZeRO-1); "manual": the batch over dp x fsdp, the
    # summed gradients handed to the fsdp moment shards (ZeRO-2), host
    # plane only; "auto": manual exactly on the tp > 1 x fsdp > 1 cell.
    # Both run tp through the same shard-local network
    # (learner.make_parallel_train_step)
    partitioning: str = "auto"

    # --- infra ------------------------------------------------------------
    seed: int = 0
    # supervision (utils/supervision.py): restart budget per worker thread,
    # seconds of silent heartbeat before a stall is reported, and seconds
    # of stall that fail the run (0 disables)
    worker_max_restarts: int = 3
    heartbeat_timeout: float = 120.0
    stall_fatal_timeout: float = 900.0
    checkpoint_dir: str = "checkpoints"
    # persist the replay contents (replay/snapshot.py) at the end of a run
    # and restore them on --resume; a preempted run also stores its mid-run
    # carry in the snapshot, so the resumed run continues bit for bit
    snapshot_replay: bool = False
    # > 0: also snapshot every N learner updates, on a background thread
    # (requires snapshot_replay)
    snapshot_every: int = 0
    # --resume across another topology (dp, process count, plane family):
    # a snapshot of another layout is re-split over this one
    # (replay/reshard.py) instead of raising TopologyMismatch
    reshard_on_resume: bool = False
    metrics_path: Optional[str] = None  # jsonl metrics file

    # --- serving plane (serve/) ---------------------------------------------
    # "int8": per-output-channel symmetric int8 weights for the encoder and
    # head kernels (ops/quantize.py), quantized at every publish and
    # dequantized in the serve step; "none" serves the parameters as they are
    serve_quantization: str = "none"
    # sessions the host spill slab holds (serve/state_cache.py): an evicted
    # session's carry is demoted there and promoted back intact; 0 = off, an
    # evicted session restarts from the zero state
    serve_spill: int = 0
    # the depth-2 serve pipeline: a completion worker resolves batch k
    # while the serve loop stages and dispatches batch k + 1; False serves
    # each batch to its end before the next (the same answers, bit for bit)
    serve_pipeline: bool = True
    # seconds between serve metrics records (0.0: one per batch), plus a
    # record at every params version and serve arm
    serve_log_interval: float = 0.0
    # replicas of the serve stack (serve/multi.py), one per device unless
    # the caller lists devices: a session's carry lives on one replica, a
    # new session goes to the least-loaded one, a reload publishes to all
    serve_devices: int = 1
    # the degradation ladder (serve/degrade.py): a "degrade-controller"
    # worker steps full -> admission shed -> bf16 weights -> int8 weights
    # and a slab shed under queue / p99 / SLO pressure; False builds none
    serve_degrade: bool = False
    # the ladder's p99 target in milliseconds (the autoscaler's SLO too)
    serve_degrade_slo_ms: float = 50.0
    # the autoscaler (serve/autoscale.py): an "autoscaler" worker adds a
    # warmed replica under sustained pressure and drains an idle one
    # through session migration when healthy; False builds none
    serve_autoscale: bool = False
    # the fleet-size band it moves in (serve_devices is the starting size)
    autoscale_min_replicas: int = 1
    autoscale_max_replicas: int = 2
    # consecutive pressured / healthy ticks before a scale event
    autoscale_dwell_up: int = 2
    autoscale_dwell_down: int = 12
    # quiet seconds after a scale event, and the evaluation tick
    autoscale_cooldown_s: float = 2.0
    autoscale_interval_s: float = 0.25
    # scale-up pressure judges p99 against this fraction of the SLO (a
    # replica takes seconds to warm; recovery judges the full SLO)
    autoscale_pressure_margin: float = 0.8
    # a drain candidate's request-free seconds
    autoscale_idle_age_s: float = 1.0
    # True: a drain waits until some replica is idle; False: the healthy
    # dwell alone drains the least-loaded replica
    autoscale_drain_requires_idle: bool = True

    # --- live loop (liveloop/) -------------------------------------------------
    # serve -> replay -> learn -> publish: a tap on every replica turns the
    # served steps into replay blocks, a trainer learns from them and its
    # checkpoints hot-reload into the fleet; False installs nothing
    liveloop: bool = False
    # share of new sessions that explore, each with a sticky epsilon drawn
    # from the Ape-X ladder over base_eps / eps_alpha; the rest are greedy
    liveloop_explore_fraction: float = 0.5
    # rungs of that ladder
    liveloop_eps_rungs: int = 8
    # bounded hand-off depths (drop-oldest, counted): served batch records
    # awaiting the tap, and finished blocks awaiting replay
    liveloop_tap_depth: int = 256
    liveloop_queue_depth: int = 64

    # --- block-stream transport (transport/) ---------------------------------
    # the live loop across processes: a serve host's BlockStreamPublisher
    # takes the bridge's replay sink and streams finished blocks to the
    # learner's IngestService; read only where those endpoints are built
    # (the pod loop's processes, tests). The publisher's unacked spool, in
    # blocks: when full the OLDEST block is shed and counted
    transport_spool_depth: int = 512
    # the spool's directory ("" = in memory only): every spooled block is
    # written as <host>/<seq>.blk before it may be sent, and a restarted
    # host reloads its unacked tail and sequence numbering from there
    transport_spool_dir: str = ""
    # the publisher's heartbeat cadence on an idle stream, and the silence
    # after which the ingest service reaps a host connection (it must
    # exceed the cadence, or healthy quiet hosts flap)
    transport_heartbeat_s: float = 1.0
    transport_dead_peer_s: float = 10.0
    # one connect-and-handshake attempt's timeout (the reconnect loop
    # backs off between attempts)
    transport_connect_timeout_s: float = 5.0

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

    @property
    def tp_shards_params(self) -> bool:
        """tp > 1 splits the parameters (every plane but multihost, which
        keeps tp = 1), the JAX package's rule."""
        return self.tp_size > 1 and self.replay_plane != "multihost"

    @property
    def resolved_partitioning(self) -> str:
        """"manual" or "gspmd": "auto" is manual exactly on the tp x fsdp
        cell."""
        if self.partitioning != "auto":
            return self.partitioning
        return "manual" if (self.tp_size > 1 and self.fsdp_size > 1) else "gspmd"

    @property
    def data_shards(self) -> int:
        """The batch shards of an update: dp, times fsdp under manual
        partitioning (the ZeRO-2 data layout)."""
        shards = max(self.dp_size, 1)
        if self.resolved_partitioning == "manual":
            shards *= max(self.fsdp_size, 1)
        return shards

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
        # the residuals live per shard: the batch splits over dp (and over
        # fsdp too under manual partitioning)
        return choose_backward_arm(
            self.seq_len,
            max(B // self.data_shards, 1),
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
        if self.tp_shards_params and self.lstm_backend == "pallas":
            # the JAX package's rule, kept so a config is valid in one
            # package exactly when it is in the other; the port's "auto"
            # runs the kernels under tp (on the tp group's gathered weights)
            raise ValueError(
                "tp_size > 1 shards the LSTM kernels; the JAX package refuses "
                "lstm_backend='pallas' there — use lstm_backend='auto'"
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
        if self.serve_quantization not in ("none", "int8"):
            raise ValueError(f"unknown serve_quantization {self.serve_quantization!r}; "
                             "'none' or 'int8'")
        if self.serve_spill < 0:
            raise ValueError("serve_spill must be >= 0 (0 disables the spill slab)")
        if self.serve_log_interval < 0.0:
            raise ValueError("serve_log_interval must be >= 0 (0.0 logs every batch)")
        if self.serve_devices < 1:
            raise ValueError(
                "serve_devices must be >= 1 (replicas of the serve stack "
                "over local devices, serve/multi.py)"
            )
        if self.serve_degrade_slo_ms <= 0.0:
            raise ValueError(
                "serve_degrade_slo_ms is the degradation ladder's p99 "
                "latency target in milliseconds (serve/degrade.py); it "
                "must be > 0"
            )
        if self.autoscale_min_replicas < 1:
            raise ValueError(
                "autoscale_min_replicas must be >= 1 (the autoscaler may "
                "never drain the last replica, serve/autoscale.py)"
            )
        if self.autoscale_max_replicas < self.autoscale_min_replicas:
            raise ValueError(
                "autoscale_max_replicas must be >= autoscale_min_replicas "
                "(the fleet-size band the autoscaler moves inside)"
            )
        if self.autoscale_dwell_up < 1 or self.autoscale_dwell_down < 1:
            raise ValueError(
                "autoscale_dwell_up/autoscale_dwell_down are consecutive-"
                "tick hysteresis dwells; both must be >= 1"
            )
        if self.autoscale_cooldown_s < 0.0:
            raise ValueError(
                "autoscale_cooldown_s is the post-scale-event quiet period "
                "in seconds; it must be >= 0"
            )
        if self.autoscale_interval_s <= 0.0:
            raise ValueError(
                "autoscale_interval_s is the autoscaler's evaluation tick "
                "interval in seconds; it must be > 0"
            )
        if self.autoscale_idle_age_s < 0.0:
            raise ValueError(
                "autoscale_idle_age_s is the drain candidate's idle "
                "threshold in seconds; it must be >= 0"
            )
        if not 0.0 < self.autoscale_pressure_margin <= 1.0:
            raise ValueError(
                "autoscale_pressure_margin is the fraction of the SLO "
                "budget at which scale-up pressure triggers; it must be "
                "in (0, 1]"
            )
        if self.serve_autoscale and not (
            self.autoscale_min_replicas
            <= self.serve_devices
            <= self.autoscale_max_replicas
        ):
            raise ValueError(
                "serve_autoscale requires the starting fleet size "
                f"(serve_devices={self.serve_devices}) to sit inside "
                f"[autoscale_min_replicas={self.autoscale_min_replicas}, "
                f"autoscale_max_replicas={self.autoscale_max_replicas}]"
            )
        if not 0.0 <= self.liveloop_explore_fraction <= 1.0:
            raise ValueError(
                "liveloop_explore_fraction is the share of live sessions "
                "assigned an exploring epsilon from the ladder; it must "
                "be in [0, 1]"
            )
        if self.liveloop_eps_rungs < 1:
            raise ValueError(
                "liveloop_eps_rungs must be >= 1 (rungs of the per-"
                "session exploration ladder, ops/epsilon.py)"
            )
        if self.liveloop_tap_depth < 1 or self.liveloop_queue_depth < 1:
            raise ValueError(
                "liveloop_tap_depth and liveloop_queue_depth are bounded "
                "hand-off queue depths; both must be >= 1"
            )
        if self.transport_spool_depth < 1:
            raise ValueError(
                "transport_spool_depth bounds the publisher's unacked "
                "block spool; it must be >= 1"
            )
        if self.transport_heartbeat_s <= 0.0 or self.transport_connect_timeout_s <= 0.0:
            raise ValueError(
                "transport_heartbeat_s and transport_connect_timeout_s "
                "must be > 0"
            )
        if self.transport_dead_peer_s <= self.transport_heartbeat_s:
            raise ValueError(
                "transport_dead_peer_s is the ingest service's silence "
                "threshold for reaping a host connection; it must exceed "
                "transport_heartbeat_s (with headroom) or healthy idle "
                "hosts flap"
            )
        if self.block_codec not in ("none", "delta-zlib"):
            raise ValueError(f"unknown block_codec {self.block_codec!r}")
        if self.replay_disk_capacity < 0:
            raise ValueError("replay_disk_capacity must be >= 0")
        if self.replay_disk_capacity > 0:
            if not self.replay_disk_dir:
                raise ValueError(
                    "replay_disk_capacity needs replay_disk_dir: the disk "
                    "tier's segment files must live somewhere"
                )
            if self.replay_disk_capacity % self.block_length != 0:
                raise ValueError(
                    "replay_disk_capacity must be a multiple of "
                    "block_length (the disk tier holds whole blocks)"
                )
            if self.replay_plane != "tiered":
                raise ValueError(
                    "the replay disk tier hangs below the tiered plane's "
                    "host slab (its staging thread is where demoted rows "
                    "are paged in + decoded); set replay_plane='tiered' "
                    "or replay_disk_capacity=0"
                )
        if self.replay_plane not in ("host", "tiered", "device", "sharded", "multihost"):
            raise ValueError(f"unknown replay_plane {self.replay_plane!r}")
        if self.dp_size < 1:
            raise ValueError("dp_size must be >= 1")
        if self.tp_size < 1:
            raise ValueError("tp_size must be >= 1")
        if self.fsdp_size < 1:
            raise ValueError("fsdp_size must be >= 1")
        if self.fsdp_size > 1 and self.replay_plane == "multihost":
            raise ValueError(
                "replay_plane='multihost' keeps params and optimizer state "
                "replicated per process; fsdp_size > 1 is a one-process mesh "
                "feature (parallel/sharding_map.py)"
            )
        if self.partitioning not in ("auto", "gspmd", "manual"):
            raise ValueError(
                f"unknown partitioning {self.partitioning!r}; 'gspmd' (ZeRO-1 "
                "moments, the batch over dp), 'manual' (ZeRO-2, the batch over "
                "dp x fsdp) or 'auto' (manual exactly on the tp x fsdp cell)"
            )
        if self.fsdp_size > 1 and self.tp_size > 1 and self.resolved_partitioning != "manual":
            # the JAX package's rule (GSPMD miscompiles tp x fsdp there),
            # kept so configs match
            raise ValueError(
                "partitioning='gspmd' composes fsdp with dp only; the tp x fsdp "
                "cell runs under partitioning='manual' (or 'auto')"
            )
        if self.resolved_partitioning == "manual":
            if self.replay_plane != "host":
                raise ValueError(
                    "partitioning='manual' is the host-batch train step "
                    "(learner.make_parallel_train_step's ZeRO-2 form); use "
                    "replay_plane='host'"
                )
            if self.tp_size > 1 and self.hidden_dim % self.tp_size != 0:
                raise ValueError(
                    f"manual tp splits the latent/gate/head kernels into contiguous "
                    f"column slices; hidden_dim={self.hidden_dim} must divide by "
                    f"tp_size={self.tp_size}"
                )
            shards = self.dp_size * self.fsdp_size
            if self.batch_size % shards != 0:
                raise ValueError(
                    f"partitioning='manual' shards the batch over dp x fsdp; "
                    f"batch_size={self.batch_size} must divide by dp_size*fsdp_size={shards}"
                )
        if self.snapshot_every < 0:
            raise ValueError("snapshot_every must be >= 0")
        if self.snapshot_every > 0 and not self.snapshot_replay:
            raise ValueError(
                "snapshot_every > 0 schedules periodic replay snapshots; "
                "it requires snapshot_replay=True"
            )
        if self.deterministic_staging and self.replay_plane != "tiered":
            raise ValueError(
                "deterministic_staging is the tiered plane's synchronous "
                "staging mode; set replay_plane='tiered' (or leave it False)"
            )
        if self.collector not in ("host", "device"):
            raise ValueError(f"unknown collector {self.collector!r}")
        if self.updates_per_dispatch < 1:
            raise ValueError("updates_per_dispatch must be >= 1")
        if self.updates_per_dispatch > 1 and self.replay_plane not in (
                "tiered", "device", "sharded", "multihost"):
            raise ValueError(
                "updates_per_dispatch > 1 is implemented for the tiered, device, "
                "sharded and multihost replay planes (staged K-batch chunks / fused "
                "in-step gathers)"
            )
        if self.training_steps % self.updates_per_dispatch != 0:
            raise ValueError(
                "training_steps must be a multiple of updates_per_dispatch "
                "(each dispatch advances the step counter by that amount)"
            )
        if self.priority_plane not in ("host", "device"):
            raise ValueError(f"unknown priority_plane {self.priority_plane!r}")
        if self.priority_plane == "device" and self.replay_plane not in ("device", "sharded"):
            raise ValueError(
                "priority_plane='device' keeps the sum tree on the card next to "
                "the store; it requires replay_plane='device' or 'sharded'"
            )
        if self.superstep_dispatches < 1:
            raise ValueError("superstep_dispatches must be >= 1")
        if self.superstep_dispatches > 1 and self.priority_plane != "device":
            raise ValueError(
                "superstep_dispatches > 1 chains N fused dispatches with "
                "in-jit sampling/write-back between them; it requires "
                "priority_plane='device'"
            )
        if self.training_steps % (self.updates_per_dispatch * self.superstep_dispatches) != 0:
            raise ValueError(
                "training_steps must be a multiple of updates_per_dispatch "
                "* superstep_dispatches (each superstep advances the step "
                "counter by that amount)"
            )
        if self.collector == "device" and self.replay_plane in ("host", "tiered"):
            raise ValueError(
                "collector='device' writes packed blocks straight into the "
                "device store; it requires replay_plane='device', 'sharded' "
                "or 'multihost'"
            )
        if self.replay_plane == "multihost" and self.tp_size != 1:
            raise ValueError("replay_plane='multihost' supports tp_size=1")
        if self.replay_plane == "sharded":
            if self.dp_size * self.tp_size <= 1:
                raise ValueError("replay_plane='sharded' needs a device mesh "
                                 "(dp_size * tp_size > 1)")
            if self.num_blocks % self.dp_size != 0:
                raise ValueError("num_blocks must divide evenly over dp_size")
            if self.batch_size % self.dp_size != 0:
                raise ValueError("batch_size must divide evenly over dp_size")
        if self.env_name:
            self._validate_env_geometry(self.env_name, self.obs_shape)
        for i, task_env in enumerate(self.multitask_envs):
            # every task renders into the shared obs canvas
            try:
                self._validate_env_geometry(task_env, self.obs_shape)
            except ValueError as e:
                raise ValueError(f"multitask_envs[{i}]: {e}") from e
        if self.num_tasks < 1:
            raise ValueError("num_tasks must be >= 1")
        if self.multitask_envs and len(self.multitask_envs) != self.num_tasks:
            raise ValueError(
                f"multitask_envs names {len(self.multitask_envs)} envs for "
                f"num_tasks={self.num_tasks}; one env name per task id"
            )
        if self.task_action_dims:
            if len(self.task_action_dims) != self.num_tasks:
                raise ValueError(
                    f"task_action_dims has {len(self.task_action_dims)} "
                    f"entries for num_tasks={self.num_tasks}"
                )
            for i, a in enumerate(self.task_action_dims):
                if not 1 <= a <= self.action_dim:
                    raise ValueError(
                        f"task_action_dims[{i}]={a} outside [1, action_dim="
                        f"{self.action_dim}] — action_dim is the union width"
                    )
        if self.task_gammas:
            if len(self.task_gammas) != self.num_tasks:
                raise ValueError(
                    f"task_gammas has {len(self.task_gammas)} entries for "
                    f"num_tasks={self.num_tasks}"
                )
            for i, g in enumerate(self.task_gammas):
                if not 0.0 < g < 1.0:
                    raise ValueError(f"task_gammas[{i}]={g} outside (0, 1)")
        return self

    def _validate_env_geometry(self, env_name: str, obs_shape) -> None:
        """Episode cap and obs shape against the name-parameterized
        families (catch, keydoor, drift, banditgrid), the JAX package's
        rules; other names (procmaze validates in its own geometry
        builder) pass through."""
        from r2d2_tpu_torch.envs.banditgrid import banditgrid_params, is_banditgrid_name
        from r2d2_tpu_torch.envs.catch import catch_params, is_catch_name
        from r2d2_tpu_torch.envs.drift import drift_params, is_drift_name
        from r2d2_tpu_torch.envs.keydoor import is_keydoor_name, keydoor_params

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
        elif is_keydoor_name(env_name):
            p = keydoor_params(env_name)
            if self.max_episode_steps < p["length"]:
                raise ValueError(
                    f"max_episode_steps={self.max_episode_steps} ends "
                    f"{env_name!r} before the door (corridor length "
                    f"{p['length']}) is reachable: every episode would "
                    "end reward-free"
                )
            if obs_shape[0] < 3 or obs_shape[1] < max(p["length"], p["num_colors"]):
                raise ValueError(
                    f"obs {obs_shape} cannot render {env_name!r}: needs "
                    f"height >= 3 and width >= "
                    f"{max(p['length'], p['num_colors'])} (corridor + cue row)"
                )
        elif is_drift_name(env_name):
            drift_params(env_name)  # raises on a bad :EVERY suffix
            if obs_shape[0] < 2 or obs_shape[1] < 3:
                raise ValueError(
                    f"obs {obs_shape} cannot render {env_name!r}: needs "
                    "height >= 2 (target + agent rows) and width >= 3"
                )
        elif is_banditgrid_name(env_name):
            p = banditgrid_params(env_name)
            if obs_shape[0] < p["grid"] or obs_shape[1] < p["grid"]:
                raise ValueError(
                    f"obs {obs_shape} cannot render {env_name!r}: the "
                    f"{p['grid']}x{p['grid']} arm grid needs height and "
                    "width >= grid"
                )
            if self.max_episode_steps < 2:
                raise ValueError(
                    f"max_episode_steps={self.max_episode_steps} gives "
                    f"{env_name!r} no post-move payout step"
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
# Presets (the JAX package's `atari`, `procgen_impala`, `long_context` and
# `tiny_test`)
# --------------------------------------------------------------------------


def default_atari(game: str = "MsPacman") -> R2D2Config:
    """The reference hyperparameters, with the JAX preset's bfloat16
    compute (f32 parameters, carries and loss math); ``--set
    compute_dtype=float32`` reproduces the reference's float32 numerics."""
    return R2D2Config(env_name=game, compute_dtype="bfloat16").validate()


def procgen_impala(game: str = "procmaze") -> R2D2Config:
    """The IMPALA-ResNet encoder preset (BASELINE.json config 4): 64x64x3
    frames through the IMPALA encoder (16, 32, 32) into the LSTM 512, in
    bf16. The default env is the procedurally generated maze
    (envs/procmaze.py), a new level every episode; on a procmaze name the
    action count and episode cap are the maze's (5, 96)."""
    from r2d2_tpu_torch.envs.procmaze import is_procmaze_name

    kw = dict(action_dim=5, max_episode_steps=96) if is_procmaze_name(game) else {}
    return R2D2Config(
        env_name=game,
        obs_shape=(64, 64, 3),
        encoder="impala",
        compute_dtype="bfloat16",
        **kw,
    ).validate()


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


def atari_v4_8(game: str = "MsPacman") -> R2D2Config:
    """256 actors and a data-parallel learner over four shards (BASELINE.json
    config 2): batch 64 split 16 a shard, bf16 compute, and the paper's
    2,000,000-transition replay held as four device stores of 500,000
    (replay_plane="sharded")."""
    return R2D2Config(
        env_name=game,
        num_actors=256,
        dp_size=4,
        batch_size=64,
        compute_dtype="bfloat16",
        replay_plane="sharded",
    ).validate()


PRESETS = {
    "atari": default_atari,
    "atari_v4_8": atari_v4_8,
    "procgen_impala": procgen_impala,
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


def apply_cli_overrides(cfg: R2D2Config, set_pairs=None, ablate_zero_state: bool = False
                        ) -> R2D2Config:
    """One resolution order for every demo and CLI: the `--set` pairs
    first, then the zero-state ablation flag, so the flag's contract
    (burn_in_steps=0 and zero_state_replay) always wins."""
    if set_pairs:
        cfg = cfg.replace(**parse_overrides(set_pairs))
    if ablate_zero_state:
        cfg = cfg.replace(burn_in_steps=0, zero_state_replay=True)
    return cfg
