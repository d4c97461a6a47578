"""The port's fault plane (r2d2_tpu_torch/utils/faults.py) against the JAX
package's (r2d2_tpu/utils/faults.py): the same spec and seed fire at exactly
the same (site, call) pairs, the spec format parses and refuses alike, the
retry policy and the jittered Backoff give the same delays, and every
registered site is wired into the port."""

import os
import re

import numpy as np
import pytest
import torch

from r2d2_tpu.utils import faults as jfaults
from r2d2_tpu_torch.utils import faults

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_planes():
    for m in (faults, jfaults):
        m.uninstall()
        m.reset_retry_stats()
    yield
    for m in (faults, jfaults):
        m.uninstall()
        m.reset_retry_stats()


def _firings(module, spec, sites, calls):
    """(site, call, action) of every firing over `calls` calls of each site,
    interleaved site by site as a run would."""
    plane = module.FaultPlane.from_spec(spec)
    for _ in range(calls):
        for site in sites:
            plane._decide(site)
    return plane.fired


@pytest.mark.parametrize("spec", [
    "trainer.update@5=sigterm",
    "trainer.update@2=error,host_plane.h2d@1=error;actor.step@7=stall:0.5",
    "tiered.stage_h2d%0.05=error,seed=7",
    "disk.write%0.3=error,disk.promote%0.2=stall:0.1,seed=11",
    "codec.decode%0.5=error,max_fires=4,seed=3",
    "snapshot.write%1.0=error,checkpoint.save@3=error,max_fires=2",
])
def test_fires_at_the_jax_planes_calls(spec):
    sites = faults.KNOWN_SITES
    got = _firings(faults, spec, sites, 200)
    want = _firings(jfaults, spec, sites, 200)
    assert got == want
    assert got  # every spec fires somewhere in 200 calls


@pytest.mark.parametrize("seed", [0, 1, 7, 12345])
def test_rate_schedule_matches_per_seed(seed):
    a = faults.FaultPlane(rates={"s": (0.3, "error")}, seed=seed)
    b = jfaults.FaultPlane(rates={"s": (0.3, "error")}, seed=seed)
    assert [a._decide("s") for _ in range(300)] == [b._decide("s") for _ in range(300)]


def test_from_spec_round_trips_as_jax_parses():
    spec = "trainer.update@5=sigterm, tiered.stage_h2d%0.05=error ;seed=7,max_fires=3"
    p, q = faults.FaultPlane.from_spec(spec), jfaults.FaultPlane.from_spec(spec)
    assert (p.schedule, p.rates, p.seed, p.max_fires) == (q.schedule, q.rates, q.seed,
                                                         q.max_fires)
    assert p.schedule == {"trainer.update": {5: "sigterm"}}
    assert p.rates == {"tiered.stage_h2d": (0.05, "error")}


@pytest.mark.parametrize("bad", ["trainer.update@5", "oops=1", "a@x=error", "a%y=error",
                                 "seed=z"])
def test_from_spec_refuses_what_jax_refuses(bad):
    with pytest.raises(ValueError) as ours:
        faults.FaultPlane.from_spec(bad)
    with pytest.raises(ValueError) as theirs:
        jfaults.FaultPlane.from_spec(bad)
    assert str(ours.value) == str(theirs.value)


def test_actions_act_and_unknown_ones_raise(monkeypatch):
    import time as _time

    slept = []
    monkeypatch.setattr(_time, "sleep", slept.append)
    plane = faults.install(faults.FaultPlane(schedule={
        "a": {1: "error"}, "b": {1: "stall:2.5"}, "c": {1: "explode"}}))
    with pytest.raises(faults.InjectedFault, match="call 1"):
        faults.fault_point("a")
    faults.fault_point("b")
    assert slept == [2.5]
    with pytest.raises(ValueError, match="unknown fault action"):
        faults.fault_point("c")
    assert [f[0] for f in plane.fired] == ["a", "b", "c"]


def test_install_from_env(monkeypatch):
    monkeypatch.delenv("R2D2_FAULTS", raising=False)
    assert faults.install_from_env() is None and faults.active() is None
    monkeypatch.setenv("R2D2_FAULTS", "trainer.update@2=error")
    plane = faults.install_from_env()
    assert faults.active() is plane
    faults.fault_point("trainer.update")
    with pytest.raises(faults.InjectedFault):
        faults.fault_point("trainer.update")


def _retry_delays(module, fails, **kw):
    slept, n = [], [0]

    def fn():
        n[0] += 1
        if n[0] <= fails:
            raise OSError("flaky")
        return "ok"

    try:
        out = module.with_retries(fn, "site", sleep=slept.append, **kw)
    except OSError:
        out = "raised"
    return out, slept, module.retry_stats()


@pytest.mark.parametrize("fails,kw", [
    (2, {}), (3, {}), (5, dict(attempts=6, base_delay=0.5, max_delay=1.5)),
    (1, dict(attempts=1)),
])
def test_with_retries_gives_jaxs_delays_and_counts(fails, kw):
    assert _retry_delays(faults, fails, **kw) == _retry_delays(jfaults, fails, **kw)


def test_with_retries_does_not_retry_logic_errors():
    def fn():
        raise KeyError("a bug")

    with pytest.raises(KeyError):
        faults.with_retries(fn, "s", sleep=lambda s: None)
    assert faults.retry_stats() == {}


@pytest.mark.parametrize("module", [faults, jfaults])
def test_with_retries_elapsed_budget(module):
    t = [0.0]

    def clock():  # one second passes at every reading
        t[0] += 1.0
        return t[0]

    def fn():
        raise OSError("flaky")

    with pytest.raises(OSError):
        module.with_retries(fn, "s", attempts=10, sleep=lambda s: None, max_elapsed=2.5,
                            clock=clock)
    # readings at 2 and 3 are inside the budget, the one at 4 is past it
    assert module.retry_stats() == {"s": 2}


@pytest.mark.parametrize("jitter,seed", [(0.0, 0), (0.5, 3), (1.0, 9)])
def test_backoff_matches_jax(jitter, seed):
    a = faults.Backoff(base=0.1, factor=2.0, max_delay=3.0, jitter=jitter, seed=seed)
    b = jfaults.Backoff(base=0.1, factor=2.0, max_delay=3.0, jitter=jitter, seed=seed)
    da = [a.fail() for _ in range(8)]
    assert da == [b.fail() for _ in range(8)]
    assert all(0.1 <= d <= 3.0 for d in da)
    a.reset()
    assert a.fail() == 0.1
    with pytest.raises(ValueError):
        faults.Backoff(jitter=1.5)


def _fault_point_literals():
    hits = {}
    pattern = re.compile(r"fault_point\(\s*\"([^\"]+)\"\s*\)")
    for d, _, names in os.walk(os.path.join(ROOT, "r2d2_tpu_torch")):
        for n in names:
            if n.endswith(".py") and n != "faults.py":
                path = os.path.join(d, n)
                for site in pattern.findall(open(path).read()):
                    hits.setdefault(site, []).append(os.path.relpath(path, ROOT))
    return hits


def test_known_sites_are_the_wired_ones():
    wired = _fault_point_literals()
    assert set(wired) == set(faults.KNOWN_SITES), wired
    # each is a site the JAX package registers under the same name
    assert set(faults.KNOWN_SITES) <= set(jfaults.KNOWN_SITES)
    for site in faults.KNOWN_SITES:
        faults.fault_point(site)  # no plane installed: a no-op


def test_codec_decode_site_drilled():
    """codec.decode through the real decode path: the scheduled call raises
    before the field is read, and the next call decodes it whole."""
    from r2d2_tpu_torch.replay.codec import decode_field, encode_field

    arr = np.arange(24, dtype=np.uint8).reshape(2, 3, 4)
    buf = encode_field(arr)
    faults.install(faults.FaultPlane(schedule={"codec.decode": {1: "error"}}))
    with pytest.raises(faults.InjectedFault):
        decode_field(buf)
    out, end = decode_field(buf)
    np.testing.assert_array_equal(out, arr)
    assert end == len(buf)


@pytest.mark.parametrize("site", [
    "serve.reload",
    "serve.replica_stall",
    "serve.replica_kill",
    "serve.slow_client",
    "autoscale.evaluate",
    "autoscale.scale_up",
    "autoscale.scale_down",
])
def test_serve_and_control_loop_sites_drilled(site):
    """Injection drill for the serve and autoscaler sites, as the JAX
    package's tests/test_faults.py drills them: each fails on its schedule
    and recovers on the next call. The port's chaos pass
    (analysis/determinism.py) counts a site as drilled only where a test
    that drives the port names it."""
    assert site in faults.KNOWN_SITES
    faults.install(faults.FaultPlane(schedule={site: {1: "error"}}))
    with pytest.raises(faults.InjectedFault):
        faults.fault_point(site)
    faults.fault_point(site)
