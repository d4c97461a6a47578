"""The serve plane's host read-back buffers (r2d2_tpu_torch/serve/server.py
_host_buffer, serve/batcher.py StagedBatch.host).

The q, action and tap-row read-back of a batch lands in host buffers that
belong to the batch's staging set: made at the set's first use, sized by
its bucket, handed to no other set, and gone with the set when it is
reallocated. They used to sit in two server dicts keyed by id() of the
set's obs buffer, never pruned: a reallocated set's buffers stayed alive
for the server's life, and a new set whose obs buffer reused a freed id
was handed the old set's buffers (the tap's with no shape check, so a
larger bucket's rows went into a smaller bucket's buffer). The path runs
on the CPU too (unpinned), so these tests hold it here; the card adds the
pinning and the event.
"""

import gc
import weakref

import numpy as np
import torch

from r2d2_tpu_torch.config import tiny_test
from r2d2_tpu_torch.liveloop import TransitionTap
from r2d2_tpu_torch.serve import PolicyServer, ServeConfig

torch.set_num_threads(1)

CFG = tiny_test()


def _server(tap: bool):
    srv = PolicyServer(CFG, ServeConfig(buckets=(2, 4), max_wait_ms=1.0, cache_capacity=16),
                       device="cpu")
    if tap:
        srv.tap = TransitionTap(CFG)
    srv.warmup()
    return srv


def _round(srv, sids, obs, reset):
    """One batch, served inline on this thread (no serve loop)."""
    futs = [srv.submit(s, o, reward=0.5, reset=reset) for s, o in zip(sids, obs)]
    srv._serve_iteration()
    return [f.result(timeout=10.0) for f in futs]


def _host_buffers(srv):
    return {key: dict(bufs["host"]) for key, bufs in srv._staging._sets.items()
            if bufs["host"]}


def test_readback_buffers_belong_to_their_staging_set():
    rng = np.random.default_rng(0)
    tapped, plain = _server(tap=True), _server(tap=False)
    sids = [f"s{i}" for i in range(4)]
    sizes = [2, 3, 2, 4, 3, 4, 2]
    replaced = []
    for r, n in enumerate(sizes):
        obs = [rng.integers(0, 255, CFG.obs_shape, dtype=np.uint8) for _ in range(n)]
        got = _round(tapped, sids[:n], obs, reset=r == 0)
        want = _round(plain, sids[:n], obs, reset=r == 0)
        for a, b in zip(got, want):
            assert (a.action, a.bucket, a.row) == (b.action, b.bucket, b.row)
            np.testing.assert_array_equal(a.q, b.q)
        if r == 3:
            # every staging set reallocated (a new served dtype, then the
            # uint8 rows again): their buffers must go with them
            replaced = [weakref.ref(t) for host in _host_buffers(tapped).values()
                        for t in host.values()]
            assert len(replaced) >= 4 * 2  # q, action, tap_h, tap_c of 2+ sets
            tapped._staging.warm(CFG.obs_shape, np.float32)
    gc.collect()
    assert replaced and all(ref() is None for ref in replaced)
    live = _host_buffers(tapped)
    assert {bucket for bucket, _ in live} == {2, 4}
    for (bucket, _flip), host in live.items():
        assert set(host) == {"q", "action", "tap_h", "tap_c"}
        assert all(t.shape[0] == bucket for t in host.values())
    ids = [id(t) for host in live.values() for t in host.values()]
    assert len(ids) == len(set(ids))  # no buffer shared between sets
    assert not any(isinstance(v, dict) and v and all(isinstance(k, int) for k in v)
                   for v in vars(tapped).values())  # no id()-keyed store left
    tapped.tap.process_pending()
    assert tapped.tap.stats()["tap_captured_steps"] > 0


def test_a_larger_bucket_never_gets_a_smaller_buckets_tap_buffer():
    """The tap rows of a bucket-4 batch staged into a set that served
    bucket 2 before: the set's buffers are remade at the new bucket (the
    shape check covers the tap's rows as well as q and the actions)."""
    srv = _server(tap=True)
    rng = np.random.default_rng(1)
    obs = [rng.integers(0, 255, CFG.obs_shape, dtype=np.uint8) for _ in range(4)]
    _round(srv, ["a", "b"], obs[:2], reset=True)
    (key2, host2), = _host_buffers(srv).items()
    # hand bucket 4's next set the bucket-2 set's buffers, as a recycled key
    # used to
    srv._staging._sets[(4, srv._staging._flip[4])]["host"].update(host2)
    res = _round(srv, ["a", "b", "c", "d"], obs, reset=False)
    assert [r.bucket for r in res] == [4] * 4
    host4 = srv._staging._sets[(4, srv._staging._flip[4] ^ 1)]["host"]
    assert all(t.shape[0] == 4 for t in host4.values())
    srv.tap.process_pending()
    assert srv.tap.stats()["tap_captured_steps"] == 2  # a and b, past their resets
