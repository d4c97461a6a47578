"""`python -m r2d2_tpu_torch.serve`: the policy service on a TCP port (port
of r2d2_tpu/serve/__main__.py).

After a training run wrote checkpoints:

    python -m r2d2_tpu_torch.serve --preset tiny_test --ckpt runs/x/ckpt \\
        --port 9955 --metrics runs/x/serve_metrics.jsonl

then from any process (this package's client or the JAX package's: the
wire format is the same):

    from r2d2_tpu_torch.serve import PolicyClient
    c = PolicyClient(port=9955)
    c.act("session-1", obs, reward=0.0, reset=True)["action"]

The checkpoint watcher keeps polling `--ckpt`, so a run still training
there goes live at each new save without a restart. Ctrl-C or a SIGTERM
stops it. Serves on the card unless `--device cpu`. `--devices N` serves a
fleet of N replicas behind a session router (serve/multi.py): on the card
one per GPU, `cuda:0 .. cuda:N-1`; with `--device cpu` all N on the CPU.
`--autoscale` makes it elastic (serve/autoscale.py; its bounds through
`--set autoscale_min_replicas=1 autoscale_max_replicas=4 ...`):

    python -m r2d2_tpu_torch.serve --device cpu --devices 2 --autoscale --dryrun 12

The JAX CLI's --compile-cache has no counterpart: the port compiles no XLA.
"""

from __future__ import annotations

import argparse
import signal
import sys
import time

import numpy as np

from r2d2_tpu_torch.config import PRESETS, apply_cli_overrides, resolve_device
from r2d2_tpu_torch.serve.client import LocalClient, serve_tcp
from r2d2_tpu_torch.serve.multi import MultiDeviceServer
from r2d2_tpu_torch.serve.server import PolicyServer, ServeConfig
from r2d2_tpu_torch.utils.metrics import MetricsLogger


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m r2d2_tpu_torch.serve",
                                description="session-stateful batched policy serving")
    p.add_argument("--preset", default="tiny_test", choices=sorted(PRESETS))
    p.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE",
                   help="R2D2Config overrides, e.g. --set hidden_dim=256")
    p.add_argument("--ckpt", default=None,
                   help="checkpoint series dir; the latest step is served and new steps "
                        "hot-reload. Omitted: freshly initialized parameters (smoke serving)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=9955)
    p.add_argument("--buckets", type=int, nargs="+", default=[2, 4, 8, 16, 32],
                   help="padded batch shapes (min 2: a batch of one breaks bitwise parity "
                        "with batched acting)")
    p.add_argument("--max-wait-ms", type=float, default=2.0)
    p.add_argument("--queue-depth", type=int, default=1024)
    p.add_argument("--cache-capacity", type=int, default=4096,
                   help="resident sessions before LRU eviction")
    p.add_argument("--poll-interval", type=float, default=0.5,
                   help="checkpoint watcher poll cadence (seconds)")
    p.add_argument("--epsilon", type=float, default=0.0)
    p.add_argument("--metrics", default=None, help="jsonl metrics path")
    p.add_argument("--devices", type=int, default=None,
                   help="serve replicas with session-affinity routing (serve/multi.py); "
                        "default cfg.serve_devices (1: one server)")
    p.add_argument("--spill", type=int, default=None,
                   help="host spill slab capacity in sessions (default cfg.serve_spill; 0 "
                        "disables: evicted sessions restart fresh)")
    p.add_argument("--autoscale", action="store_true",
                   help="elastic fleet (serve/autoscale.py): add a replica under sustained "
                        "SLO pressure, drain an idle one through session migration; bounds "
                        "and dwells through --set autoscale_min_replicas=1 ...")
    p.add_argument("--dryrun", type=int, default=0, metavar="N",
                   help="serve N synthetic requests in-process (no TCP) and exit 0")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    args = p.parse_args(argv)

    cfg = apply_cli_overrides(PRESETS[args.preset](), args.set)
    if args.devices is not None:
        cfg = cfg.replace(serve_devices=args.devices)
    if args.spill is not None:
        cfg = cfg.replace(serve_spill=args.spill)
    if args.autoscale:
        cfg = cfg.replace(serve_autoscale=True)
    serve_cfg = ServeConfig(buckets=tuple(args.buckets), max_wait_ms=args.max_wait_ms,
                            queue_depth=args.queue_depth, cache_capacity=args.cache_capacity,
                            poll_interval_s=args.poll_interval, epsilon=args.epsilon)
    metrics = MetricsLogger(args.metrics) if args.metrics else None
    if cfg.serve_devices > 1 or cfg.serve_autoscale:
        # an elastic fleet of one is still a fleet: only it can add, drain
        # and route
        devices = None
        if resolve_device(args.device).type == "cpu":
            devices = ["cpu"] * cfg.serve_devices
        server = MultiDeviceServer(cfg, serve_cfg, checkpoint_dir=args.ckpt, metrics=metrics,
                                   devices=devices)
        elastic = (f" (elastic, {cfg.autoscale_min_replicas}..{cfg.autoscale_max_replicas})"
                   if cfg.serve_autoscale else "")
        print(f"[serve] {cfg.serve_devices} replicas{elastic}: "
              f"{[str(d) for d in server.devices]}", file=sys.stderr)
    else:
        server = PolicyServer(cfg, serve_cfg, checkpoint_dir=args.ckpt, metrics=metrics,
                              device=args.device)
    print(f"[serve] warming up {len(serve_cfg.buckets)} bucket shapes", file=sys.stderr)
    server.warmup()
    server.start()
    if args.dryrun:
        try:
            client = LocalClient(server)
            rng = np.random.default_rng(0)
            for i in range(args.dryrun):
                sid = f"dry-{i % max(args.dryrun // 2, 1)}"
                obs = rng.integers(0, 255, cfg.obs_shape, np.uint8)
                client.act(sid, obs, reward=0.0, reset=False)
            server.check()
            st = server.stats()
            print(f"[serve] dryrun ok: {args.dryrun} requests, ckpt_step={st['ckpt_step']} "
                  f"step shapes={st['trace_count']} devices={st.get('serve_devices', 1)}",
                  file=sys.stderr)
            return 0
        finally:
            server.stop()
            if metrics is not None:
                metrics.close()
    tcp, _ = serve_tcp(server, host=args.host, port=args.port)

    def interrupt(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, interrupt)  # a SIGTERM stops it as Ctrl-C does
    host, port = tcp.server_address[:2]
    print(f"[serve] listening on {host}:{port} (ckpt_step={server.stats()['ckpt_step']})",
          file=sys.stderr, flush=True)
    try:
        while True:
            time.sleep(5.0)
            server.check()  # raises WorkerFatalError when a worker died
    except KeyboardInterrupt:
        return 0
    finally:
        tcp.shutdown()
        tcp.server_close()
        server.stop()
        if metrics is not None:
            metrics.close()


if __name__ == "__main__":
    sys.exit(main())
