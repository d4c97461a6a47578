"""A serving fleet: replicas of the serve stack behind a session router
(port of r2d2_tpu/serve/multi.py).

One `PolicyServer` per device, each with its own micro-batcher, session
cache and slab, network module and supervised workers, and a
`SessionRouter` in front that pins every session to one replica. A
session's carry lives on one replica only, so a request routed anywhere
else would restart the session from the zero state: affinity is
correctness, not only locality.

Routing:

- a mapped session goes to its replica, always;
- a new session goes to the replica with the fewest tracked sessions, ties
  broken by crc32 of the session id, so equal loads still spread the same
  way on every host;
- the map is LRU-bounded to the fleet's session capacity (device rows and
  slab rows of every active replica): a session old enough to fall out of
  it has also aged out of its replica's cache and slab, so placing it anew
  loses nothing.

Devices are torch devices and may repeat (two replicas on one card, as
the live loop's test places them); with no list the fleet takes
`cuda:0 .. cuda:n-1` for `serve_devices = n`. Each replica owns its
network module on its own device: the step's functional_call swaps a
module's parameters while it runs, so two serve threads never share one.

A reload restores the checkpoint once on the host, prepares every active
replica's copy outside the reload lock (the cast or quantization and the
copy to its device), then installs all of them under one fleet version in
one critical section: once it returns, no two replicas serve different
versions. An arm switch of the degradation ladder (serve/degrade.py, one
controller for the fleet) and a replica added by the autoscaler
(serve/autoscale.py) keep the same discipline. `kill_replica` retires a
replica and migrates its sessions through the survivors' spill slabs,
carries intact.

The JAX fleet shares one jitted-step cache across replicas; the port
compiles nothing, and each replica counts its own step shapes
(`trace_count`).
"""

from __future__ import annotations

import threading
import time
import zlib
from collections import OrderedDict
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence

import torch

from r2d2_tpu_torch.config import R2D2Config, resolve_device
from r2d2_tpu_torch.learner import init_train_state
from r2d2_tpu_torch.serve.autoscale import Autoscaler
from r2d2_tpu_torch.serve.degrade import DegradeConfig, DegradeController
from r2d2_tpu_torch.serve.server import PolicyServer, ServeConfig
from r2d2_tpu_torch.serve.state_cache import dtype_name
from r2d2_tpu_torch.utils.checkpoint import latest_checkpoint_step, restore_checkpoint
from r2d2_tpu_torch.utils.faults import Backoff, InjectedFault, fault_point
from r2d2_tpu_torch.utils.metrics import MetricsLogger
from r2d2_tpu_torch.utils.supervision import Supervisor


class SessionRouter:
    """Session -> replica affinity with least-loaded placement of new
    sessions. Thread-safe: any client thread may route."""

    def __init__(self, n_replicas: int, max_tracked: int = 0):
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        self.n_replicas = n_replicas
        # 0 = unbounded; else LRU-drop the stalest affinity past the bound
        self.max_tracked = max_tracked
        # each active replica's share of the bound: the bound follows the
        # active set as the autoscaler grows or drains the fleet
        self._per_replica = max_tracked // n_replicas if max_tracked else 0
        self._map: "OrderedDict[str, int]" = OrderedDict()
        self._counts = [0] * n_replicas
        # a killed replica is deactivated, never removed: indices stay
        # stable, and its unmigrated sessions place anew on their next route
        self._active = [True] * n_replicas
        self._lock = threading.Lock()
        self.routed = 0      # route() calls
        self.new_routes = 0  # sessions placed for the first time
        self.dropped = 0     # affinities LRU-dropped from the map
        self.reroutes = 0    # affinities moved off a deactivated replica

    def _recompute_bound(self) -> None:
        # caller holds self._lock; 0 stays unbounded
        if self._per_replica:
            self.max_tracked = self._per_replica * max(sum(self._active), 1)

    def _trim(self) -> None:  # r2d2: guarded-by(_lock)  (the caller-holds contract below)
        # caller holds self._lock: LRU-drop down to the (maybe shrunk) bound
        while self.max_tracked and len(self._map) > self.max_tracked:
            _, old_replica = self._map.popitem(last=False)
            self._counts[old_replica] -= 1
            self.dropped += 1

    def route(self, session_id: str) -> int:
        """The replica index this session's requests go to."""
        with self._lock:
            replica = self._map.get(session_id)
            if replica is not None and not self._active[replica]:
                # mapped to a dead replica and not migrated: place anew
                del self._map[session_id]
                self._counts[replica] -= 1
                self.reroutes += 1
                replica = None
            if replica is None:
                live = [i for i in range(self.n_replicas) if self._active[i]]
                if not live:
                    raise RuntimeError("no active replicas to route to")
                self.new_routes += 1
                lo = min(self._counts[i] for i in live)
                ties = [i for i in live if self._counts[i] == lo]
                replica = ties[zlib.crc32(session_id.encode()) % len(ties)]
                self._counts[replica] += 1
                self._map[session_id] = replica
                self._trim()
            self._map.move_to_end(session_id)
            self.routed += 1
            return replica

    def deactivate(self, replica: int) -> None:
        """Take a replica out of rotation (kill or drain); its affinities
        stay until migrated or routed anew, and the bound shrinks."""
        with self._lock:
            self._active[replica] = False
            self._recompute_bound()
            self._trim()

    def activate(self, replica: int) -> None:
        """Put a replica (back) into rotation; the bound grows."""
        with self._lock:
            self._active[replica] = True
            self._recompute_bound()

    def add_slot(self) -> int:
        """One more inactive slot (activated once its replica is warmed and
        published, so no session lands on a replica not yet serving)."""
        with self._lock:
            self.n_replicas += 1
            self._counts.append(0)
            self._active.append(False)
            return self.n_replicas - 1

    def assign(self, session_id: str, replica: int) -> None:
        """Force a session's affinity (migration), moving its count."""
        with self._lock:
            old = self._map.pop(session_id, None)
            if old is not None:
                self._counts[old] -= 1
            self._map[session_id] = replica
            self._map.move_to_end(session_id)
            self._counts[replica] += 1

    def active(self) -> List[bool]:
        with self._lock:
            return list(self._active)

    def peek(self, session_id: str) -> Optional[int]:
        """The mapped replica, or None; never creates an affinity."""
        with self._lock:
            return self._map.get(session_id)

    def forget(self, session_id: str) -> Optional[int]:
        """Drop a session's affinity (disconnect); -> its replica or None."""
        with self._lock:
            replica = self._map.pop(session_id, None)
            if replica is not None:
                self._counts[replica] -= 1
            return replica

    def counts(self) -> List[int]:
        with self._lock:
            return list(self._counts)

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {
                "router_sessions": len(self._map),
                "router_counts": list(self._counts),
                "router_active": list(self._active),
                "router_routed": self.routed,
                "router_new_routes": self.new_routes,
                "router_dropped": self.dropped,
                "router_reroutes": self.reroutes,
            }


def _device_family(device: torch.device) -> List[torch.device]:
    """Every local device of `device`'s type: the CPU, or each card."""
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


class MultiDeviceServer:
    """PolicyServer replicas behind a SessionRouter, with the single
    server's lifecycle (construct, `warmup()`, `start()`, `submit()` or a
    client, `check()`, `stop()`). The checkpoint watcher lives here (the
    replicas start without one): one restore a new step, one fleet version,
    published to every active replica."""

    def __init__(
        self,
        cfg: R2D2Config,
        serve_cfg: ServeConfig = ServeConfig(),
        params=None,
        checkpoint_dir: Optional[str] = None,
        metrics: Optional[MetricsLogger] = None,
        devices: Optional[Sequence] = None,
    ):
        if devices is None:
            resolve_device("cuda")  # raises without a card
            visible = torch.cuda.device_count()
            if cfg.serve_devices > visible:
                raise ValueError(f"serve_devices={cfg.serve_devices} but only {visible} "
                                 "local devices are visible")
            devices = [torch.device("cuda", i) for i in range(cfg.serve_devices)]
        devices = [resolve_device(d) for d in devices]
        if len(devices) < 1:
            raise ValueError("need at least one device")
        self.cfg = cfg
        self.serve_cfg = serve_cfg
        self.checkpoint_dir = checkpoint_dir
        self.metrics = metrics
        self.devices = tuple(devices)

        # restore once for the whole fleet; the replicas get host copies
        # and place (and cast or quantize) them per device
        _, self._template = init_train_state(cfg, self.devices[0], seed=serve_cfg.seed)
        ckpt_step = -1
        if params is None:
            if checkpoint_dir is not None and latest_checkpoint_step(checkpoint_dir) is not None:
                state, _, _ = restore_checkpoint(checkpoint_dir, self._template,
                                                 map_location=self.devices[0])
                params, ckpt_step = state.net.state_dict(), int(state.step)
            else:
                params = self._template.net.state_dict()  # fresh init (smoke serving)
        self._params_host = _host_copy(params)

        # one ladder for the fleet: every replica takes it in, and only
        # this server runs its worker
        self.degrade: Optional[DegradeController] = None
        self._arm = "full"
        if cfg.serve_degrade:
            self.degrade = DegradeController(self, DegradeConfig(slo_ms=cfg.serve_degrade_slo_ms))
        self.replicas: List[PolicyServer] = [
            PolicyServer(cfg, serve_cfg, params=self._params_host, metrics=metrics, device=d,
                         name=f"d{i}", template=self._template, degrade=self.degrade)
            for i, d in enumerate(self.devices)
        ]
        # the replicas published version 0 at step -1; publish the restored
        # step again so the first batch's provenance is right
        self._reload_lock = threading.Lock()
        self._version = 0
        self._ckpt_step = ckpt_step
        if ckpt_step >= 0:
            for r in self.replicas:
                r.publish(self._params_host, ckpt_step, version=0)

        per_replica = serve_cfg.cache_capacity + cfg.serve_spill
        self.router = SessionRouter(len(self.replicas),
                                    max_tracked=per_replica * len(self.replicas))
        self.replicas_killed = 0
        self.replicas_added = 0
        self.sessions_migrated = 0
        self.sessions_lost = 0
        # sessions placed anew on a survivor before their carry was
        # imported: alive, restarted from the zero state
        self.sessions_restarted = 0
        # requests queued on a killed replica, answered by its successor
        self.requests_rerouted = 0
        self.reloads = 0
        self.reload_errors = 0
        self._watch_backoff = Backoff(base=serve_cfg.poll_interval_s, factor=2.0,
                                      max_delay=max(30.0, serve_cfg.poll_interval_s))
        self.supervisor: Optional[Supervisor] = None
        # the autoscaler (serve/autoscale.py), its own supervised worker;
        # off by default
        self.autoscale = None
        if cfg.serve_autoscale:
            self.autoscale = Autoscaler(self)

    # ------------------------------------------------------------- serving

    def submit(self, session_id: str, obs, reward: float = 0.0, reset: bool = False,
               epsilon: Optional[float] = None, task: int = 0) -> Future:
        """Route to the session's replica (a new session to the least-loaded
        one) and enqueue on its batcher."""
        replica = self.router.route(session_id)
        return self.replicas[replica].submit(session_id, obs, reward=reward, reset=reset,
                                             epsilon=epsilon, task=task)

    def replica_for(self, session_id: str) -> Optional[PolicyServer]:
        """The replica owning this session (None if unrouted)."""
        idx = self.router.peek(session_id)
        return None if idx is None else self.replicas[idx]

    def reset_session(self, session_id: str) -> None:
        """Zero a session's carry on its replica; the affinity stays."""
        idx = self.router.peek(session_id)
        if idx is not None:
            self.replicas[idx].reset_session(session_id)

    def evict(self, session_id: str) -> None:
        """Disconnect: free the session everywhere (device row, slab row,
        affinity, and its live-loop epsilon and partial block)."""
        idx = self.router.forget(session_id)
        if idx is not None:
            self.replicas[idx].evict(session_id)

    # ---------------------------------------------------------- chaos plane

    def kill_replica(self, idx: int) -> Dict[str, int]:
        """Retire one replica and migrate its sessions to the survivors
        through their spill slabs. The order is the argument:

        1. deactivate its routing: no new request reaches it;
        2. close its batcher (a racing submit fails fast with
           QueueFullError) and take the requests still queued there;
        3. stop its workers (a batch already formed is answered): its
           cache has no writer after the join, so
        4. export_sessions() is every session at its last written carry,
           and each is imported into its new replica's host slab (no
           survivor's resident session is evicted for it); the carry
           promotes back bit for bit at the session's next request;
        5. the requests taken in 2 go to their sessions' new replicas, in
           their order, and answer their clients' futures there.

        A session whose client sent again between 1 and 4 was placed anew
        already: `restarted` (its import is skipped, the survivor holds the
        newer state). A session with no slab row left is `lost`. -> the
        counts; they add up in stats(). The JAX fleet fails the requests
        queued on the victim (its clients retry); the port carries them
        over, so a kill costs no answer."""
        victim = self.replicas[idx]
        self.router.deactivate(idx)
        victim.batcher.close()
        queued = victim.batcher.drain()
        victim.stop()
        exported = victim.cache.export_sessions()
        migrated = lost = restarted = 0
        for sid, (h, c, la, lr) in exported.items():
            target = self.router.route(sid)  # least-loaded survivor
            cache = self.replicas[target].cache
            if sid in cache or cache.spilled(sid):
                restarted += 1
                continue
            if cache.import_spilled(sid, h, c, la, lr):
                self.router.assign(sid, target)
                migrated += 1
            else:
                self.router.forget(sid)
                # a full disconnect: the live-loop hooks are the fleet's, so
                # a lost session must not strand its epsilon or partial block
                victim.evict(sid)
                lost += 1
        for req in queued:
            if not req.future.done():
                _forward(self.submit(req.session_id, req.obs, reward=req.reward,
                                     reset=req.reset, epsilon=req.epsilon, task=req.task),
                         req.future)
        with self._reload_lock:
            self.replicas_killed += 1
            self.sessions_migrated += migrated
            self.sessions_lost += lost
            self.sessions_restarted += restarted
            self.requests_rerouted += len(queued)
        return {"migrated": migrated, "lost": lost, "restarted": restarted}

    def _pick_device(self) -> torch.device:
        """A local device no replica holds, if there is one; else replicas
        share the devices round-robin (on the CPU, and two to a card)."""
        local = _device_family(self.devices[0])
        free = [d for d in local if d not in self.devices]
        if free:
            return free[0]
        return local[len(self.replicas) % len(local)]

    def add_replica(self, device=None) -> int:
        """Grow the fleet by one replica (the autoscaler's scale-up; also
        callable directly), in an order that keeps routing and publishing
        whole:

        1. build it from the fleet's host parameters and template, with
           the fleet's ladder and live-loop hooks (never its own worker);
        2. warmup(): every bucket runs and the staging buffers exist
           before any traffic can reach it;
        3. start its workers (on a running fleet) while the router has no
           slot for it;
        4. prepare its copy of the current (params, step, arm) outside the
           reload lock, then install it at the fleet's version and activate
           its slot in one critical section, preparing again if a reload or
           an arm switch landed meanwhile.

        -> its index. Scale events are serialized by the caller."""
        device = self._pick_device() if device is None else resolve_device(device)
        replica = PolicyServer(self.cfg, self.serve_cfg, params=self._params_host,
                               metrics=self.metrics, device=device,
                               name=f"d{len(self.replicas)}", template=self._template,
                               degrade=self.degrade)
        r0 = self.replicas[0]
        # the live-loop hooks are one instance for the fleet
        replica.tap = r0.tap
        replica.eps_assigner = r0.eps_assigner
        if self.autoscale is not None:
            self.autoscale.attach(replica)
        replica.warmup()
        if self.supervisor is not None:
            replica.start(watch_checkpoints=False)
        slot = self.router.add_slot()
        while True:
            with self._reload_lock:
                raw, step, version, arm = (self._params_host, self._ckpt_step, self._version,
                                           self._arm)
            prepared = replica.prepare_for_publish(raw, arm)
            with self._reload_lock:
                if (self._version, self._ckpt_step, self._arm) != (version, step, arm):
                    continue  # a reload or an arm switch landed meanwhile
                replica.install_prepared(prepared, step, version=version, raw_params=raw)
                if len(self.replicas) == slot:
                    self.replicas.append(replica)
                    self.devices = self.devices + (device,)
                self.replicas_added += 1
                # activated inside the same critical section: from its first
                # routed request on, every fleet publish includes it
                self.router.activate(slot)
            return slot

    # ------------------------------------------------------ degrade surface
    # (as PolicyServer's, so serve/degrade.py drives either; the actions
    # fan out to the active replicas)

    @property
    def queue_bound(self) -> int:
        # per replica: the ladder answers the most pressed replica, not an
        # aggregate a straggler hides in
        return self.serve_cfg.queue_depth

    def _alive(self) -> List[PolicyServer]:
        return [r for r, a in zip(self.replicas, self.router.active()) if a]

    def active_replicas(self) -> int:
        """Replicas taking routed traffic (the autoscaler's fleet size)."""
        return sum(1 for a in self.router.active() if a)

    def queue_depth(self) -> int:
        return max((r.queue_depth() for r in self._alive()), default=0)

    def set_admission(self, limit: Optional[int], budget: int = 0) -> None:
        """The admission watermark on every active replica (limit and shed
        budget per replica: each queue is its own overload domain)."""
        for r in self._alive():
            r.set_admission(limit, budget=budget)

    def shed_spill(self, keep_fraction: float) -> int:
        return sum(r.shed_spill(keep_fraction) for r in self._alive())

    def _snapshot(self):
        # what a fleet publish prepares from and installs into; the caller
        # holds _reload_lock
        return (self._params_host, self._ckpt_step, self._version, self._arm, self._alive())

    def _same(self, a, b) -> bool:
        return a[0] is b[0] and a[1:] == b[1:]

    def set_arm(self, arm: str) -> bool:
        """Fleet arm switch: prepare every active replica's copy outside the
        reload lock, install them all under one version. Under the lock the
        arm is checked again (the ladder's pin and its worker may switch to
        one arm at once, and only the first may bump the version; the JAX
        fleet bumps it twice), and so is the rest of the fleet's state: a
        reload or a new replica that landed meanwhile makes it prepare
        again, as add_replica does."""
        while True:
            with self._reload_lock:
                if arm == self._arm:
                    return False
                snap = self._snapshot()
            raw, step, _, _, alive = snap
            staged = [r.prepare_for_publish(raw, arm) for r in alive]
            with self._reload_lock:
                if arm == self._arm:
                    return False  # a concurrent switch to this arm landed first
                if not self._same(snap, self._snapshot()):
                    continue  # a reload or a scale event landed meanwhile
                version = self._version + 1
                for r, prepared in zip(alive, staged):
                    r.install_prepared(prepared, step, version=version)
                    r.arm_switches += 1
                self._version = version
                self._arm = arm
            return True

    # ----------------------------------------------------------- hot reload

    def reload_now(self) -> bool:
        """One reload check for the fleet: restore the newest step once,
        prepare every active replica's copy outside the reload lock (in the
        fleet's arm), install all under one version. -> whether new
        parameters went live."""
        fault_point("serve.reload")
        step = latest_checkpoint_step(self.checkpoint_dir)
        if step is None or step == self._ckpt_step:
            return False
        state, _, _ = restore_checkpoint(self.checkpoint_dir, self._template, step,
                                         map_location=self.devices[0])
        self.publish_params(state.net.state_dict(), int(state.step))
        return True

    def publish_params(self, params, ckpt_step: int, version: Optional[int] = None) -> None:
        """Fleet-wide publish of parameters held in memory (reload_now
        without the restore), prepared in the fleet's arm; `version`
        defaults to the next fleet version. An arm switch or a scale event
        that lands while it prepares makes it prepare again."""
        raw = _host_copy(params)
        ckpt_step = int(ckpt_step)
        version = None if version is None else int(version)
        while True:
            with self._reload_lock:
                snap = self._snapshot()
            _, _, _, arm, alive = snap
            staged = [r.prepare_for_publish(raw, arm) for r in alive]
            with self._reload_lock:
                if not self._same(snap, self._snapshot()):
                    continue
                v = self._version + 1 if version is None else version
                for r, prepared in zip(alive, staged):
                    r.install_prepared(prepared, ckpt_step, version=v, raw_params=raw)
                self._params_host = raw
                self._version = v
                self._ckpt_step = ckpt_step
                self.reloads += 1
            return

    def _wait(self, seconds: float) -> None:
        if self.supervisor is not None:
            self.supervisor.stop.wait(seconds)
        else:
            time.sleep(seconds)

    def _watch_iteration(self) -> None:
        # as PolicyServer's: one poll, backoff on transient restore trouble
        try:
            self.reload_now()
        except (OSError, InjectedFault):
            with self._reload_lock:
                self.reload_errors += 1
            wait = self._watch_backoff.fail()
        else:
            self._watch_backoff.reset()
            wait = self.serve_cfg.poll_interval_s
        self._wait(wait)

    def _degrade_iteration(self) -> None:
        self.degrade.evaluate_once()
        self._wait(self.degrade.cfg.eval_interval_s)

    # ------------------------------------------------------------ lifecycle

    def warmup(self) -> None:
        for r in self.replicas:
            r.warmup()

    def start(self, watch_checkpoints: Optional[bool] = None) -> None:
        if self.supervisor is not None:
            raise RuntimeError("server already started")
        if watch_checkpoints is None:
            watch_checkpoints = self.checkpoint_dir is not None
        for r in self.replicas:
            r.start(watch_checkpoints=False)
        self.supervisor = Supervisor()
        if watch_checkpoints:
            self.supervisor.spawn("ckpt-watcher-multi", lambda: self._watch_iteration(),
                                  max_restarts=self.serve_cfg.max_restarts)
        if self.degrade is not None:
            self.supervisor.spawn("degrade-controller-multi", lambda: self._degrade_iteration(),
                                  max_restarts=self.serve_cfg.max_restarts)
        if self.autoscale is not None:
            # its own supervised root: a scale event blocks for seconds
            self.autoscale.start()

    def check(self) -> Dict[str, int]:
        out = {"worker_restarts": 0, "worker_stalls": 0}
        sups = [r.supervisor for r in self.replicas] + [self.supervisor]
        if self.autoscale is not None:
            sups.append(self.autoscale.supervisor)
        for sup in sups:
            if sup is not None:
                c = sup.check()
                out["worker_restarts"] += c.get("worker_restarts", 0)
                out["worker_stalls"] += c.get("worker_stalls", 0)
        return out

    def stop(self, timeout: float = 5.0) -> None:
        if self.autoscale is not None:
            # first: no scale event may fire into a stopping fleet
            self.autoscale.stop(timeout)
        if self.supervisor is not None:
            self.supervisor.shutdown(timeout)
            self.supervisor = None
        for r in self.replicas:
            r.stop(timeout)

    # ------------------------------------------------------------- metrics

    # counters summed over the replicas in stats(); each replica's own are
    # under "replicas"
    _SUMMED = (
        "cache_sessions", "cache_evictions", "cache_admissions",
        "cache_hits", "cache_misses", "cache_readmits", "cache_spills",
        "cache_promotes", "cache_spill_evictions", "spill_sessions",
        "cache_imports", "cache_spill_sheds",
        "requests", "batches", "rejected", "shed", "deferrals",
        "queue_depth", "trace_count", "quantized_leaves", "arm_switches",
        "completed_batches", "metrics_skipped",
    )

    def stats(self) -> Dict[str, object]:
        per_replica = [r.stats() for r in self.replicas]
        active = self.router.active()
        out: Dict[str, object] = {
            "serve_devices": len(self.replicas),
            "ckpt_step": self._ckpt_step,
            "params_version": self._version,
            "serve_arm": self._arm,
            "reloads": self.reloads,
            "reload_errors": self.reload_errors,
            "replicas_killed": self.replicas_killed,
            "replicas_added": self.replicas_added,
            "sessions_migrated": self.sessions_migrated,
            "sessions_lost": self.sessions_lost,
            "sessions_restarted": self.sessions_restarted,
            "requests_rerouted": self.requests_rerouted,
            "serve_quantization": self.cfg.serve_quantization,
            # the idle signals the autoscaler's drain reads, per replica
            "replica_active": active,
            "replica_inflight": [s.get("inflight_depth", 0) for s in per_replica],
            "replica_last_request_age_s": [round(s.get("last_request_age_s", 0.0), 4)
                                           for s in per_replica],
        }
        for key in self._SUMMED:
            out[key] = sum(s.get(key, 0) for s in per_replica)
        lookups = out["cache_hits"] + out["cache_misses"]
        out["cache_hit_rate"] = out["cache_hits"] / lookups if lookups else 0.0
        batches = sum(r.batcher.batches for r in self.replicas)
        occ = sum(r.batcher.occupancy_sum for r in self.replicas)
        padded = sum(r.batcher.padded_sum for r in self.replicas)
        out["mean_batch_occupancy"] = occ / max(batches, 1)
        out["bucket_fill"] = occ / max(padded, 1)
        cache0 = self.replicas[0].cache
        out["cache_dtype"] = dtype_name(cache0.dtype)
        out["session_carry_bytes"] = cache0.session_carry_bytes
        # only the active replicas' rows can hold sessions
        out["cache_capacity"] = sum(r.cache.capacity for r, a in zip(self.replicas, active) if a)
        out["spill_capacity"] = sum(r.cache.spill_capacity
                                    for r, a in zip(self.replicas, active) if a)
        out.update(self.router.stats())
        # the live-loop tap and assigner are one instance on every replica:
        # their stats pass through once
        for key, val in per_replica[0].items():
            if key.startswith(("eps_", "tap_")):
                out[key] = val
        if self.degrade is not None:
            out.update(self.degrade.stats())
        if self.autoscale is not None:
            out.update(self.autoscale.stats())
        out["replicas"] = per_replica
        return out


def _forward(src: Future, dst: Future) -> None:
    """Resolve `dst` with `src`'s outcome when `src` is done."""

    def done(f: Future) -> None:
        exc = f.exception()
        if exc is None:
            dst.set_result(f.result())
        else:
            dst.set_exception(exc)

    src.add_done_callback(done)


def _host_copy(params) -> Dict[str, torch.Tensor]:
    """A CPU copy of a state_dict (the fleet's raw parameters)."""
    return {k: v.detach().to("cpu", copy=True) for k, v in params.items()}
