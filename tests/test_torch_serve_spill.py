"""The port's session spill slab on the CPU, as tests/test_serve_spill.py
holds the JAX package's: evict -> demote -> promote returns the exact bits
that left the device in fp32 and bf16, the slab's LRU drop and the
promote/demote ordering within one batch, reset and evict dropping spilled
state, a spilled session served exactly as one never evicted, sessions at
8x the cache capacity keeping their carries, and a migration export and
import. The router and the multi-device cases are in
tests/test_torch_serve_fleet.py. tiny_test shapes."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from r2d2_tpu.serve.state_cache import RecurrentStateCache as JaxCache
from r2d2_tpu_torch.config import tiny_test
from r2d2_tpu_torch.serve import LocalClient, PolicyServer, ServeConfig, reference_act
from r2d2_tpu_torch.serve.state_cache import RecurrentStateCache

torch.set_num_threads(1)

STATE_DTYPES = [pytest.param(torch.float32, torch.int32, id="fp32"),
                pytest.param(torch.bfloat16, torch.int16, id="bf16")]


def _bits(t, as_int):
    return t.contiguous().view(as_int)


@pytest.mark.parametrize("dtype,as_int", STATE_DTYPES)
def test_cache_spill_round_trip_bit_exact(dtype, as_int):
    cache = RecurrentStateCache(capacity=2, hidden_dim=4, dtype=dtype, spill_capacity=4,
                                device="cpu")
    (slot_a,), fresh = cache.assign(["a"])
    assert fresh[0]
    rng = np.random.default_rng(0)
    h_a = torch.from_numpy(rng.normal(size=4).astype(np.float32)).to(dtype)
    c_a = torch.from_numpy(rng.normal(size=4).astype(np.float32)).to(dtype)
    idx = torch.tensor([int(slot_a)])
    cache.write(idx, h_a[None], c_a[None], torch.tensor([3]), torch.tensor([1.25]))
    cache.assign(["b"])
    cache.assign(["x"])  # capacity 2: "a" is the LRU, demoted to the slab
    assert "a" not in cache and cache.spilled("a") and cache.spills == 1
    assert cache._spill_h.dtype == dtype and not cache._spill_h.is_cuda
    (slot_a2,), fresh2 = cache.assign(["a"])  # promoted, not fresh
    assert not fresh2[0] and not cache.spilled("a") and "a" in cache
    assert torch.equal(_bits(cache.h[slot_a2], as_int), _bits(h_a, as_int))
    assert torch.equal(_bits(cache.c[slot_a2], as_int), _bits(c_a, as_int))
    assert int(cache.last_action[slot_a2]) == 3 and float(cache.last_reward[slot_a2]) == 1.25
    st = cache.stats()
    assert st["cache_readmits"] == 1 and st["cache_promotes"] == 1 and st["cache_spills"] == 2
    assert st["cache_dtype"] == str(dtype).replace("torch.", "")


def test_cache_counters_match_jax():
    """One assign stream through both caches: the same slots, fresh flags
    and counters (the host-side LRU and slab logic is the same)."""
    rng = np.random.default_rng(4)
    port = RecurrentStateCache(capacity=3, hidden_dim=2, spill_capacity=2, device="cpu")
    jax_cache = JaxCache(capacity=3, hidden_dim=2, spill_capacity=2)
    for _ in range(60):
        ids = list(dict.fromkeys(f"s{int(i)}" for i in rng.integers(0, 8, 2)))
        if rng.random() < 0.1:
            sid = f"s{int(rng.integers(0, 8))}"
            assert port.evict(sid) == jax_cache.evict(sid)
            continue
        got, want = port.assign(ids), jax_cache.assign(ids)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    jstats = jax_cache.stats()
    for k, v in port.stats().items():
        if k != "cache_dtype":
            assert jstats[k] == v, k


def test_cache_promote_survives_same_batch_demote():
    """One assign that both promotes a returning session and demotes a
    victim must not hand the promoted session's slab row to the victim
    before it is read (capacity 1 does both on every miss)."""
    cache = RecurrentStateCache(capacity=1, hidden_dim=2, spill_capacity=1, device="cpu")
    (slot,), _ = cache.assign(["a"])
    h_a = torch.tensor([[7.0, -7.0]])
    cache.write(torch.tensor([int(slot)]), h_a, h_a, torch.tensor([1]), torch.tensor([0.5]))
    cache.assign(["b"])
    (slot2,), fresh = cache.assign(["a"])
    assert not fresh[0]
    assert torch.equal(cache.h[slot2], h_a[0])
    assert cache.spilled("b") and cache.spill_evictions == 0


def test_cache_slab_lru_drop_starts_fresh():
    cache = RecurrentStateCache(capacity=1, hidden_dim=2, spill_capacity=1, device="cpu")
    cache.assign(["a"])
    cache.assign(["b"])
    cache.assign(["x"])  # b -> slab, slab full: a dropped for good
    assert cache.spill_evictions == 1 and not cache.spilled("a")
    assert cache.assign(["a"])[1][0]


def test_cache_reset_and_evict_drop_spilled_state():
    cache = RecurrentStateCache(capacity=1, hidden_dim=2, spill_capacity=4, device="cpu")
    cache.assign(["a"])
    cache.assign(["b"])  # a spilled
    cache.reset("a")
    assert not cache.spilled("a") and cache.assign(["a"])[1][0]
    cache.assign(["b"])
    assert cache.spilled("a")
    assert cache.evict("a") and not cache.spilled("a")
    assert len(cache._spill_free) == 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_export_and_import_keep_the_carry(dtype):
    """Every session exported LRU-oldest first (spilled ones before the
    resident), and an import into another cache's slab promotes back the
    same bits."""
    src = RecurrentStateCache(capacity=2, hidden_dim=3, dtype=dtype, spill_capacity=4,
                              device="cpu")
    for i, sid in enumerate(["a", "b", "c"]):
        (slot,), _ = src.assign([sid])
        v = torch.full((1, 3), 0.1 * (i + 1)).to(dtype)
        src.write(torch.tensor([int(slot)]), v, -v, torch.tensor([i]), torch.tensor([float(i)]))
    out = src.export_sessions()
    assert list(out) == ["a", "b", "c"]  # a was spilled by c
    dst = RecurrentStateCache(capacity=2, hidden_dim=3, dtype=dtype, spill_capacity=4,
                              device="cpu")
    for sid, rows in out.items():
        assert dst.import_spilled(sid, *rows)
    assert not dst.import_spilled("a", *out["a"])  # already tracked
    (slot,), fresh = dst.assign(["b"])
    assert not fresh[0] and dst.imports == 3
    assert torch.equal(dst.h[slot], out["b"][0]) and int(dst.last_action[slot]) == 1
    assert dst.shed_spill(0.0) == 2 and dst.spill_sheds == 2


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_served_spill_round_trip_matches_never_evicted(precision):
    """A session pushed out to the slab and promoted back between every one
    of its requests answers as the same session on a server that never
    evicts it, bit for bit, in fp32 and bf16."""
    cfg = tiny_test().replace(precision=precision)
    srv_spill = PolicyServer(cfg.replace(serve_spill=16),
                             ServeConfig(buckets=(2,), max_wait_ms=1.0, cache_capacity=2),
                             device="cpu")
    srv_big = PolicyServer(cfg, ServeConfig(buckets=(2,), max_wait_ms=1.0, cache_capacity=64),
                           device="cpu")
    for s in (srv_spill, srv_big):
        s.warmup()
        s.start()
    cl_spill, cl_big = LocalClient(srv_spill), LocalClient(srv_big)
    rng = np.random.default_rng(7)
    try:
        for t in range(8):
            obs = rng.integers(0, 255, cfg.obs_shape, dtype=np.uint8)
            reward = float(rng.normal())
            res_s = cl_spill.act("s", obs, reward=reward, reset=t == 0)
            res_b = cl_big.act("s", obs, reward=reward, reset=t == 0)
            np.testing.assert_array_equal(res_s.q, res_b.q)
            assert res_s.action == res_b.action
            cl_spill.act(f"fill-{t}-0", obs, reset=True)
            cl_spill.act(f"fill-{t}-1", obs, reset=True)
    finally:
        srv_spill.stop()
        srv_big.stop()
    st = srv_spill.stats()
    assert st["cache_readmits"] >= 7 and st["cache_promotes"] >= 7 and st["cache_spills"] >= 7
    assert st["cache_dtype"] == ("bfloat16" if precision == "bf16" else "float32")


def test_sessions_8x_capacity_carry_continuity():
    """64 sessions over an 8-row cache, three round-robin passes: every
    request misses the device rows, and every answer is the session's
    uninterrupted reference's."""
    n_sessions, rounds = 64, 3
    cfg = tiny_test().replace(serve_spill=n_sessions * 2)
    srv = PolicyServer(cfg, ServeConfig(buckets=(2, 4, 8), max_wait_ms=1.0, cache_capacity=8),
                       device="cpu")
    srv.warmup()
    srv.start()
    client = LocalClient(srv)
    params = srv.served_params()
    rng = np.random.default_rng(11)
    carries = [None] * n_sessions
    last = [0] * n_sessions
    try:
        for rnd in range(rounds):
            for s in range(n_sessions):
                obs = rng.integers(0, 255, cfg.obs_shape, dtype=np.uint8)
                reward = float(rng.normal())
                reset = rnd == 0
                res = client.act(f"pop-{s}", obs, reward=reward, reset=reset)
                if reset:
                    carries[s] = (np.zeros((1, cfg.hidden_dim), np.float32),) * 2
                    last[s], reward = 0, 0.0
                q, (h, c) = reference_act(srv.net, params, obs[None], np.array([last[s]]),
                                          np.array([reward], np.float32), carries[s],
                                          min_batch=res.bucket, row=res.row)
                np.testing.assert_array_equal(q[0].numpy(), res.q)
                assert int(np.argmax(res.q)) == res.action
                carries[s], last[s] = (h.numpy(), c.numpy()), res.action
    finally:
        srv.stop()
    st = srv.stats()
    assert st["cache_readmits"] == n_sessions * (rounds - 1)
    assert st["cache_hits"] == 0
    assert st["spill_sessions"] <= cfg.serve_spill and st["cache_spill_evictions"] == 0
