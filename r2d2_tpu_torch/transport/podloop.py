"""Pod-loop processes (port of r2d2_tpu/transport/podloop.py): serve hosts
feed one learner over the block-stream transport, across real process
boundaries.

    python -m r2d2_tpu_torch.transport.podloop --role learner \\
        --ckpt-dir /tmp/pod/ckpt --stats /tmp/pod/learner.jsonl
    python -m r2d2_tpu_torch.transport.podloop --role serve \\
        --learner-port P --host-id h0 --spool-dir /tmp/pod/spool \\
        --stats /tmp/pod/h0.jsonl

Each prints one JSON line `{"podloop_ready": true, ...}` with its port
when it is up (the learner's `ingest_port`, a host's `serve_port`).

Serve host: a one-replica `MultiDeviceServer` behind the JSON-lines TCP
frontend, with the live loop's capture stack (`LiveLoopPlane`) whose
"replay" is a `BlockStreamPublisher`: finished blocks stream to the
learner instead of a local store. Checkpoints come back on the same
socket; a CKPT is rebuilt against the host's own parameters
(`framing.params_from_leaves`) and installed through
`MultiDeviceServer.publish_params`, so a reload needs no shared file
system (no checkpoint watcher runs).

Learner: a `LiveLoopTrainer` whose replay fills from an `IngestService`;
every `save_interval` crossing broadcasts the trained parameters to every
connected host under the next version. On the card the kernels are built
before the learner reports ready, and a failed build ends it non-zero: it
never trains on the plain versions.

Both append one JSON line a second to `--stats` (counters only; the
learner's carry `lstm_launches`, the kernel launches of this process) and
exit cleanly on SIGTERM after draining.

`--preset` (default tiny_test, the JAX module's fixed config) picks the
run preset under the pod's fields (`podloop_config`), and `--set KEY=VALUE`
overrides follow; every process of one pod takes the same ones, since a
CKPT carries leaves only. `--device` defaults to cuda and refuses to fall
back to the CPU; `--device cpu` runs the pod on the CPU.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading
import time

import numpy as np

from r2d2_tpu_torch.config import PRESETS, parse_overrides, resolve_device

# the JAX package's pod fields (r2d2_tpu/transport/podloop.py
# podloop_config), laid over the run preset
POD_FIELDS = dict(
    env_name="catch",
    action_dim=3,
    liveloop=True,
    save_interval=20,
    learning_starts=128,
    buffer_capacity=4096,
    training_steps=1_000_000,  # the wall clock ends a run, not the step count
    serve_spill=64,
    transport_heartbeat_s=0.5,
    transport_dead_peer_s=5.0,
)


def podloop_config(preset: str = "tiny_test", checkpoint_dir: str = "", spool_dir: str = "",
                   overrides=()):
    """The one config every process of a pod builds: a host's network must
    be the learner's (a CKPT ships leaves only, rebuilt locally)."""
    return PRESETS[preset]().replace(**{
        **POD_FIELDS, "checkpoint_dir": checkpoint_dir, "transport_spool_dir": spool_dir,
        **parse_overrides(overrides)})


def _emit_stats(path: str, row: dict) -> None:
    if path:
        with open(path, "a") as f:
            f.write(json.dumps(row, default=str) + "\n")


def _install_sigterm(stop: threading.Event) -> None:
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())


def _launches() -> dict:
    from r2d2_tpu_torch.ops import lstm_kernel

    return {k: v for k, v in lstm_kernel.launch_counts.items() if v}


def run_serve_host(host_id: str, learner_port: int, port: int = 0, spool_dir: str = "",
                   stats_path: str = "", seed: int = 0, learner_host: str = "127.0.0.1",
                   stats_interval_s: float = 1.0, preset: str = "tiny_test", overrides=(),
                   device="cuda") -> None:
    from r2d2_tpu_torch.liveloop import LiveLoopPlane
    from r2d2_tpu_torch.serve import MultiDeviceServer, ServeConfig, serve_tcp
    from r2d2_tpu_torch.transport import framing
    from r2d2_tpu_torch.transport.publisher import BlockStreamPublisher

    dev = resolve_device(device)
    cfg = podloop_config(preset, spool_dir=spool_dir, overrides=overrides)
    serve_cfg = ServeConfig(buckets=(2, 4, 8), max_wait_ms=2.0, cache_capacity=32,
                            poll_interval_s=3600.0,  # reloads arrive as CKPT frames
                            seed=seed)
    server = MultiDeviceServer(cfg, serve_cfg, devices=[dev])
    template = dict(server._params_host)

    def apply_ckpt(leaves, step, version):
        server.publish_params(framing.params_from_leaves(leaves, template), step,
                              version=version)

    publisher = BlockStreamPublisher(cfg, (learner_host, learner_port), host_id,
                                     on_checkpoint=apply_ckpt, seed=seed)
    plane = LiveLoopPlane(cfg, server, replay=publisher, seed=seed)
    # the tap appends a block's audit entry just before the emit that
    # reaches the publisher, on the same thread: the newest entry is the
    # block being offered
    publisher.audit_source = lambda: plane.tap.audit_tail[-1] if plane.tap.audit_tail else None

    server.warmup()
    server.start(watch_checkpoints=False)
    plane.start()
    publisher.start()
    tcp, _ = serve_tcp(server, port=port)

    stop = threading.Event()
    _install_sigterm(stop)
    print(json.dumps({"podloop_ready": True, "role": "serve", "host": host_id,
                      "serve_port": tcp.server_address[1]}), flush=True)

    t0 = time.time()

    def row(**extra):
        return {"t": round(time.time() - t0, 3), "role": "serve", "host": host_id, **extra,
                **{k: v for k, v in server.stats().items()
                   if isinstance(v, (int, float, str, bool))},
                **plane.stats(), **publisher.stats(), "lstm_launches": _launches()}

    while not stop.is_set():
        plane.check()
        publisher.check()
        server.check()
        _emit_stats(stats_path, row())
        stop.wait(stats_interval_s)

    tcp.shutdown()
    tcp.server_close()
    plane.stop()      # the final tap and bridge drains land in the publisher
    publisher.stop()  # flush: spool -> learner, best effort
    server.stop()
    _emit_stats(stats_path, row(final=True))


def run_learner(port: int, checkpoint_dir: str, stats_path: str = "", seed: int = 0,
                host: str = "127.0.0.1", stats_interval_s: float = 1.0,
                preset: str = "tiny_test", overrides=(), device="cuda") -> None:
    import torch

    from r2d2_tpu_torch.liveloop import LiveLoopTrainer
    from r2d2_tpu_torch.ops import _build
    from r2d2_tpu_torch.transport import framing
    from r2d2_tpu_torch.transport.ingest import IngestService

    dev = resolve_device(device)
    cfg = podloop_config(preset, checkpoint_dir=checkpoint_dir, overrides=overrides)
    if dev.type == "cuda":
        _build.build(_build.sources())  # raises with nvcc's output: no fallback
    trainer = LiveLoopTrainer(cfg, device=dev)
    version = {"n": 0}
    service = IngestService(cfg, trainer.replay, host=host, port=port,
                            version_source=lambda: version["n"])
    service.start()

    stop = threading.Event()
    _install_sigterm(stop)
    print(json.dumps({"podloop_ready": True, "role": "learner",
                      "ingest_port": service.port}), flush=True)

    t0 = time.time()
    tr = trainer.trainer
    # the launches of one update, per train() call (each distinct shape once)
    per_update = set()
    # seconds inside train() (sampling, updates, checkpoint saves) and in
    # the broadcasts' flatten and encode
    spent = {"train_s": 0.0, "broadcast_s": 0.0}

    def row(**extra):
        out = {"t": round(time.time() - t0, 3), "role": "learner", **extra,
               "params_version": version["n"], **trainer.stats(), **service.stats(),
               "lstm_launches": _launches(),
               "launches_per_update": [json.loads(s) for s in sorted(per_update)], **spent}
        if tr.update_seconds:
            out["update_ms_p50"] = float(np.median(tr.update_seconds)) * 1e3
            out["train_wall_s"] = tr.update_ends[-1] - (tr.update_ends[0] - tr.update_seconds[0])
        if dev.type == "cuda":
            out["peak_allocated_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        return out

    last_stats = 0.0
    last_ckpt_bucket = 0
    while not stop.is_set():
        service.check()
        if trainer.can_train():
            before = _launches()
            t = time.perf_counter()
            n = trainer.train(8, deadline=time.monotonic() + 0.5)
            spent["train_s"] += time.perf_counter() - t
            if n:
                moved = {k: (v - before.get(k, 0)) / n for k, v in _launches().items()
                         if v != before.get(k, 0)}
                per_update.add(json.dumps(moved, sort_keys=True))
        else:
            stop.wait(0.05)
        bucket = trainer.step // cfg.save_interval
        if bucket > last_ckpt_bucket:
            last_ckpt_bucket = bucket
            version["n"] += 1
            t = time.perf_counter()
            service.broadcast_checkpoint(framing.params_to_leaves(tr.state.net), trainer.step,
                                         version["n"])
            spent["broadcast_s"] += time.perf_counter() - t
        now = time.time()
        if now - last_stats >= stats_interval_s:
            last_stats = now
            _emit_stats(stats_path, row())

    trainer.finish()
    service.stop()
    # the seams of one batch as the learner draws it (the kernels' inputs)
    seams = ({"sampled_burn_in": trainer.replay.sample_batch(
        np.random.default_rng(seed)).burn_in_steps.tolist()} if trainer.can_train() else {})
    _emit_stats(stats_path, row(final=True, **seams))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m r2d2_tpu_torch.transport.podloop",
                                description="pod-loop process bodies")
    p.add_argument("--role", required=True, choices=["serve", "learner"])
    p.add_argument("--port", type=int, default=0,
                   help="serve: TCP frontend port; learner: ingest port")
    p.add_argument("--learner-port", type=int, default=0,
                   help="serve role: the learner's ingest port")
    p.add_argument("--learner-host", default="127.0.0.1")
    p.add_argument("--host-id", default="h0")
    p.add_argument("--spool-dir", default="")
    p.add_argument("--ckpt-dir", default="")
    p.add_argument("--stats", default="")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--preset", default="tiny_test", choices=sorted(PRESETS))
    p.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE",
                   help="R2D2Config overrides, the same in every process of the pod")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    common = dict(stats_path=args.stats, seed=args.seed, preset=args.preset,
                  overrides=args.set, device=args.device)
    if args.role == "serve":
        if not args.learner_port:
            p.error("--role serve requires --learner-port")
        run_serve_host(host_id=args.host_id, learner_port=args.learner_port, port=args.port,
                       spool_dir=args.spool_dir, learner_host=args.learner_host, **common)
    else:
        run_learner(port=args.port, checkpoint_dir=args.ckpt_dir, **common)
    return 0


if __name__ == "__main__":
    sys.exit(main())
