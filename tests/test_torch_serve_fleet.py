"""The port's serving fleet (r2d2_tpu_torch/serve/multi.py) on the CPU, as
the multi-device cases of tests/test_serve_spill.py hold the JAX package's:
two replicas on ["cpu", "cpu"], tiny_test shapes.

- the session router places, keeps, drops and re-places sessions as JAX's
  SessionRouter does on one seeded stream of operations, LRU bound
  included;
- fleet answers match JAX's reference_act on the same parameters (Q to
  1e-5) and the port's own reference_act bit for bit, each session on one
  replica, new sessions on the less-loaded one;
- a reload publishes to both replicas under one version (plain and int8),
  and a checkpoint landing under traffic goes live on both with no torn
  batch; `--devices 2 --device cpu --dryrun` exits 0; each replica owns its
  network module.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from r2d2_tpu.serve import SessionRouter as JaxSessionRouter
from r2d2_tpu.serve import reference_act as jax_reference_act
from r2d2_tpu_torch.config import tiny_test
from r2d2_tpu_torch.serve import (
    LocalClient,
    MultiDeviceServer,
    ServeConfig,
    SessionRouter,
)
from r2d2_tpu_torch.serve.__main__ import main as serve_main
from r2d2_tpu_torch.utils.checkpoint import save_checkpoint
from tests.test_torch_serve import SessionReference, _jax_pair, _scaled_state

torch.set_num_threads(1)

CPU2 = ["cpu", "cpu"]


def fleet(cfg, serve_cfg=None, **kw):
    return MultiDeviceServer(cfg, serve_cfg or ServeConfig(buckets=(2, 4), max_wait_ms=1.0,
                                                           cache_capacity=8),
                             devices=CPU2, **kw)


# ------------------------------------------------------------- the router


def _router_ops(seed, n_replicas, n=400):
    """A seeded stream of router operations over 24 session ids, with one
    more slot added half way."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(n):
        if i == n // 2:
            ops.append(("add_slot",))
            n_replicas += 1
        u = rng.random()
        sid = f"u{int(rng.integers(0, 24))}"
        replica = int(rng.integers(0, n_replicas))
        if u < 0.75:
            ops.append(("route", sid))
        elif u < 0.85:
            ops.append(("forget", sid))
        elif u < 0.9:
            ops.append(("assign", sid, replica))
        elif u < 0.95:
            ops.append(("deactivate", replica))
        else:
            ops.append(("activate", replica))
    return ops


def _play(router, ops):
    out = []
    for op in ops:
        kind, args = op[0], op[1:]
        if kind == "route":
            try:
                out.append(router.route(*args))
            except RuntimeError as e:  # every replica deactivated
                out.append(str(e))
        else:
            out.append(getattr(router, kind)(*args))
        out.append((router.counts(), router.active(), router.max_tracked))
    return out, router.stats()


@pytest.mark.parametrize("n_replicas,max_tracked,seed", [(2, 0, 0), (3, 0, 1), (2, 12, 2),
                                                         (3, 9, 3)])
def test_router_placements_match_jax(n_replicas, max_tracked, seed):
    """One seeded stream of routes, forgets, forced assigns, kills, revivals
    and a scale-up slot: the same placements, counts, bounds and stats."""
    ops = _router_ops(seed, n_replicas)
    got = _play(SessionRouter(n_replicas, max_tracked), ops)
    want = _play(JaxSessionRouter(n_replicas, max_tracked), ops)
    assert got == want
    assert got[1]["router_new_routes"] > 0
    if max_tracked:
        assert got[1]["router_dropped"] > 0


def test_router_affinity_and_least_loaded():
    r = SessionRouter(3)
    first = {sid: r.route(sid) for sid in ("a", "b", "c")}
    assert sorted(first.values()) == [0, 1, 2]
    for sid, rep in first.items():
        for _ in range(3):
            assert r.route(sid) == rep
    assert r.counts() == [1, 1, 1]
    assert r.peek("a") == first["a"] and r.peek("nope") is None
    assert r.forget("a") == first["a"] and r.peek("a") is None
    assert r.route("d") == first["a"]  # the freed replica is least-loaded
    st = r.stats()
    assert st["router_new_routes"] == 4 and st["router_sessions"] == 3


def test_router_lru_bound_drops_stalest():
    r = SessionRouter(2, max_tracked=2)
    r.route("a")
    r.route("b")
    r.route("a")  # "b" is now the stalest
    r.route("c")
    assert r.peek("b") is None and r.peek("a") is not None
    assert r.dropped == 1 and sum(r.counts()) == 2


# -------------------------------------------------------------- the fleet


def test_fleet_matches_jax_and_its_own_reference():
    """Six sessions over two replicas: every answer equals JAX's
    reference_act on the same parameters to 1e-5 and the port's own at the
    bucket and row it was served at, bit for bit; a session never changes
    replica; the sessions spread 3 / 3."""
    jnet, jparams, cfg, params = _jax_pair({"serve_spill": 16})
    srv = fleet(cfg, params=params)
    assert len(srv.replicas) == 2
    srv.warmup()
    srv.start()
    client = LocalClient(srv)
    rng = np.random.default_rng(3)
    n_sessions, n_steps = 6, 6
    own = [SessionReference(srv.replicas[0].net, cfg.hidden_dim) for _ in range(n_sessions)]
    ref = [SessionReference(jnet, cfg.hidden_dim, act=jax_reference_act)
           for _ in range(n_sessions)]
    owners = {}
    try:
        for t in range(n_steps):
            for s in range(n_sessions):
                sid = f"md-{s}"
                obs = rng.integers(0, 255, cfg.obs_shape, dtype=np.uint8)
                reward = float(rng.normal())
                res = client.act(sid, obs, reward=reward, reset=t == 0)
                replica = srv.replica_for(sid)
                q_own, a_own = own[s].step(replica.served_params(), obs, reward, t == 0,
                                           bucket=res.bucket, row=res.row)
                np.testing.assert_array_equal(q_own, res.q)
                assert a_own == res.action
                q_ref, _ = ref[s].step(jparams, obs, reward, t == 0, bucket=res.bucket)
                np.testing.assert_allclose(res.q, q_ref, rtol=0, atol=1e-5)
                ref[s].last_action = np.array([res.action], np.int32)
                assert owners.setdefault(sid, srv.router.peek(sid)) == srv.router.peek(sid)
    finally:
        srv.stop()
    assert srv.router.counts() == [3, 3]
    for rep in srv.replicas:
        assert rep.trace_count == len(rep.batcher.buckets)
    st = srv.stats()
    assert st["serve_devices"] == 2 and st["requests"] == n_sessions * n_steps
    assert st["router_new_routes"] == n_sessions
    assert st["cache_hits"] == n_sessions * (n_steps - 1)


def test_replicas_own_their_modules():
    """functional_call swaps a module's parameters while it runs: no two
    replicas may share one."""
    srv = fleet(tiny_test().replace(serve_spill=4))
    a, b = srv.replicas
    assert a.net is not b.net and a._acting is not b._acting
    assert not set(map(id, a.net.parameters())) & set(map(id, b.net.parameters()))
    added = srv.add_replica()
    assert srv.replicas[added].net is not a.net and srv.devices[added] == torch.device("cpu")


def test_fleet_without_a_device_list_needs_cards():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiDeviceServer(tiny_test().replace(serve_devices=2), ServeConfig(buckets=(2,),
                                                                            cache_capacity=4))


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_fleet_reload_lockstep(tmp_path, quant):
    """One reload_now() restores once and publishes to both replicas under
    one version: the same steps, versions and prepared tensors (int8
    quantized too) on both after every reload."""
    cfg = tiny_test().replace(serve_quantization=quant)
    ckpt = str(tmp_path / "ckpt")
    srv = fleet(cfg, ServeConfig(buckets=(2,), max_wait_ms=1.0, cache_capacity=4),
                checkpoint_dir=ckpt)

    def published():
        return [(r._published[1], r._published[2]) for r in srv.replicas]

    assert published() == [(-1, 0), (-1, 0)]
    for step, scale in ((1, 1.5), (2, 3.0)):
        save_checkpoint(ckpt, _scaled_state(srv.replicas[0], scale, step), 0, 0.0)
        assert srv.reload_now()
        assert published() == [(step, srv._version)] * 2
        a, b = (r._published[0] for r in srv.replicas)
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], dict):
                for kk in a[k]:
                    assert torch.equal(a[k][kk], b[k][kk]), (k, kk)
            else:
                assert torch.equal(a[k], b[k]), k
        if quant == "int8":
            assert all(r.quantized_leaves > 0 for r in srv.replicas)
    assert not srv.reload_now()
    assert srv.reloads == 2


def test_fleet_reload_under_traffic(tmp_path):
    """A checkpoint landing under traffic goes live on both replicas through
    the fleet's watcher; every answer is the port's reference under the
    version that answered it, bit for bit (none torn)."""
    cfg = tiny_test()
    ckpt = str(tmp_path / "ckpt")
    srv = fleet(cfg, ServeConfig(buckets=(2, 4), max_wait_ms=1.0, cache_capacity=8,
                                 poll_interval_s=0.05), checkpoint_dir=ckpt)
    params_by_version = {0: srv.replicas[0].served_params()}
    srv.warmup()
    srv.start()
    client = LocalClient(srv)
    n_sessions, stop = 4, threading.Event()
    records = [[] for _ in range(n_sessions)]
    errors: list = []

    def run(i):
        rng = np.random.default_rng(100 + i)
        first = True
        try:
            while not stop.is_set():
                obs = rng.integers(0, 255, cfg.obs_shape, dtype=np.uint8)
                reward = 0.0 if first else float(rng.normal())
                res = client.act(f"rl-{i}", obs, reward=reward, reset=first)
                records[i].append((obs, reward, first, res))
                first = False
        except Exception as e:  # pragma: no cover - failure detail
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n_sessions)]
    for t in threads:
        t.start()
    time.sleep(0.3)
    save_checkpoint(ckpt, _scaled_state(srv.replicas[0], 1.25, 1), 0, 0.0)
    deadline = time.monotonic() + 20.0
    while srv._version != 1 and time.monotonic() < deadline:
        time.sleep(0.02)
    assert srv._version == 1, "the fleet's watcher never published the checkpoint"
    params_by_version[1] = srv.replicas[0].served_params()
    deadline = time.monotonic() + 20.0
    while time.monotonic() < deadline:
        if all(any(r.params_version == 1 for *_, r in rec) for rec in records):
            break
        time.sleep(0.02)
    stop.set()
    for t in threads:
        t.join(timeout=30.0)
    srv.check()
    srv.stop()
    assert not errors, errors
    assert [r._published[2] for r in srv.replicas] == [1, 1]
    for i in range(n_sessions):
        assert any(r.params_version == 1 for *_, r in records[i])
        ref = SessionReference(srv.replicas[0].net, cfg.hidden_dim)
        for obs, reward, reset, res in records[i]:
            q_ref, a_ref = ref.step(params_by_version[res.params_version], obs, reward, reset,
                                    bucket=res.bucket, row=res.row)
            np.testing.assert_array_equal(q_ref, res.q)
            assert a_ref == res.action


def test_serve_cli_dryrun_devices2():
    assert serve_main(["--preset", "tiny_test", "--device", "cpu", "--devices", "2",
                       "--spill", "8", "--dryrun", "6", "--buckets", "2", "4",
                       "--cache-capacity", "8", "--max-wait-ms", "1.0"]) == 0
