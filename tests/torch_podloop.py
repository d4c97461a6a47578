"""The pod loop driven across real processes, for the CPU suite
(tests/test_torch_transport.py) and the card's chip_smoke.py phase 27:
imports nothing of JAX.

`run_pod` starts one learner and N serve hosts as subprocesses of
`python -m r2d2_tpu_torch.transport.podloop`, on ports it picks first, and
closed-loop catch sessions in client processes of this file (an 84x84
observation costs a few ms of one interpreter to put into the JSON-lines
request, so one process cannot offer hundreds of requests a second). It
SIGKILLs host h0 part way and relaunches it with the same host id, spool
directory and serve port, then drains the hosts and the learner with
SIGTERM and reads their stats files. `pod_failures` lists the conditions
the run broke.

    python tests/torch_podloop.py --ports P0,P1 --sessions 0,1,2,3 \\
        --rate 25 --out clients.json

is one client process: it prints `{"clients_ready": true}`, reads
"<t0> <until>" (wall-clock seconds) from its standard input, runs its
sessions (session i against port i mod N) until `until` (a later line
moves it), and writes its latencies and counts to `--out`.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np

import r2d2_tpu_torch
from r2d2_tpu_torch.transport.podloop import podloop_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(r2d2_tpu_torch.__file__)))
# sessions per client process; seconds a child may take to come up (a host
# takes about 20 s on the card) and to drain
SESSIONS_PER_CLIENT = 4
READY_TIMEOUT = 240.0
DRAIN_TIMEOUT = 60.0
# the window is stretched so that the relaunched h0 serves at least this
# long: its relaunch takes 20-26 s on the card, more on a slower machine
AFTER_RELAUNCH = 10.0


class _Child:
    """One process: stdout and stderr to files under the run's root."""

    def __init__(self, root, name, argv, env, stdin=None):
        self.name = name
        self.out_path = os.path.join(root, f"{name}.out")
        self.err_path = os.path.join(root, f"{name}.log")
        self.t_spawn = time.time()
        with open(self.out_path, "w") as out, open(self.err_path, "w") as err:
            self.proc = subprocess.Popen([sys.executable, *argv], stdout=out, stderr=err,
                                         stdin=stdin, env=env, cwd=ROOT)

    def wait_ready(self, timeout, key="podloop_ready"):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with open(self.out_path) as f:
                for line in f:
                    if line.startswith("{") and f'"{key}"' in line:
                        self.ready_s = time.time() - self.t_spawn
                        return json.loads(line)
            if self.proc.poll() is not None:
                raise RuntimeError(f"{self.name} exited {self.proc.returncode} before it was "
                                   f"ready:\n{self.tail()}")
            time.sleep(0.1)
        raise RuntimeError(f"{self.name} not ready in {timeout:.0f}s:\n{self.tail()}")

    def tail(self, n=3000):
        with open(self.err_path) as f:
            return f.read()[-n:]


def _free_ports(n):
    """n ports free on the loopback now (each process binds its own)."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def last_stats(path, role=None):
    """The newest stats row of a stats file (a torn last line from a
    SIGKILL is skipped)."""
    best = {}
    try:
        with open(path) as f:
            for line in f:
                try:
                    row = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if role is None or row.get("role") == role:
                    best = row
    except OSError:
        pass
    return best


def run_pod(root, device="cuda", preset="tiny_test", sets=(), hosts=2, sessions=8,
            rate=25.0, seconds=40.0, kill_frac=0.4):
    """One pod run with the SIGKILL drill on h0 at `kill_frac` of a window
    of `seconds`, stretched to leave the relaunched h0 AFTER_RELAUNCH
    seconds. `rate` is each session's offered requests per second; session
    i goes to host i mod `hosts`.
    -> a dict of the learner's and each host's final stats rows, the
    drill's readings, the clients' counts and latencies, and every child's
    exit code."""
    spool = os.path.join(root, "spool")
    ckpt = os.path.join(root, "ckpt")
    os.makedirs(spool, exist_ok=True)
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [ROOT, env.get("PYTHONPATH")]))
    cfg = podloop_config(preset, overrides=sets)
    ingest_port, *host_ports = _free_ports(1 + hosts)
    learner_stats = os.path.join(root, "learner.jsonl")
    host_stats = [os.path.join(root, f"h{i}.jsonl") for i in range(hosts)]
    pod = ["-m", "r2d2_tpu_torch.transport.podloop", "--preset", preset, "--device", device,
           *(["--set", *sets] if sets else [])]
    children, clients = [], []
    res = {"rcs": {}, "early_exits": {}}

    def host(i, tag=""):
        child = _Child(root, f"h{i}{tag}", [
            *pod, "--role", "serve", "--host-id", f"h{i}", "--seed", str(i),
            "--learner-port", str(ingest_port), "--port", str(host_ports[i]),
            "--spool-dir", spool, "--stats", host_stats[i]], env)
        children.append(child)
        return child

    try:
        # every process starts at once: the ports are known beforehand, and
        # a host that is up before the learner reconnects under its backoff
        learner = _Child(root, "learner", [
            *pod, "--role", "learner", "--port", str(ingest_port),
            "--ckpt-dir", ckpt, "--stats", learner_stats], env)
        children.append(learner)
        host_children = [host(i) for i in range(hosts)]
        groups = [list(range(s, min(s + SESSIONS_PER_CLIENT, sessions)))
                  for s in range(0, sessions, SESSIONS_PER_CLIENT)]
        for k, group in enumerate(groups):
            clients.append(_Child(root, f"clients{k}", [
                os.path.abspath(__file__), "--ports", ",".join(map(str, host_ports)),
                "--sessions", ",".join(map(str, group)), "--rate", str(rate),
                "--obs", ",".join(map(str, cfg.obs_shape[:2])),
                "--out", os.path.join(root, f"clients{k}.json")], env,
                stdin=subprocess.PIPE))
        learner.wait_ready(READY_TIMEOUT)
        for c in host_children:
            c.wait_ready(READY_TIMEOUT)
        for c in clients:
            c.wait_ready(READY_TIMEOUT, key="clients_ready")
        res["ready_s"] = {c.name: c.ready_s for c in children + clients}

        t0 = time.time() + 0.5
        until = t0 + seconds
        for c in clients:
            c.proc.stdin.write(f"{t0} {until}\n".encode())
            c.proc.stdin.flush()

        def watch(t_end):
            """Sleep until wall time `t_end`, noting any child that exits on
            its own."""
            while time.time() < t_end:
                for c in children:
                    if c.proc.poll() is not None and c.name not in res["early_exits"]:
                        res["early_exits"][c.name] = c.proc.returncode
                time.sleep(0.2)

        # the drill: SIGKILL h0 at kill_frac of the window, relaunch it with
        # its id, spool directory and serve port
        watch(t0 + kill_frac * seconds)
        pre = last_stats(learner_stats)
        res["h0_seq_at_kill"] = int(pre.get("ingest_host_seq", {}).get("h0", 0))
        res["step_at_kill"] = int(pre.get("learner_step", 0))
        h0 = host_children[0]
        h0.proc.send_signal(signal.SIGKILL)
        res["rcs"]["h0 (killed)"] = h0.proc.wait(timeout=30.0)
        children.remove(h0)
        res["t_kill_s"] = time.time() - t0
        # the clients keep going while h0 comes back, however long that
        # takes; the window is set to its final end below
        for c in clients:
            c.proc.stdin.write(f"{time.time() + READY_TIMEOUT}\n".encode())
            c.proc.stdin.flush()
        back = host(0, tag="_relaunched").wait_ready(READY_TIMEOUT)
        res["t_back_s"] = time.time() - t0
        res["relaunched_on_same_port"] = back["serve_port"] == host_ports[0]
        res["step_at_relaunch"] = int(last_stats(learner_stats).get("learner_step", 0))
        until = max(until, time.time() + AFTER_RELAUNCH)
        for c in clients:
            c.proc.stdin.write(f"{until}\n".encode())
            c.proc.stdin.close()
        watch(until)

        for c in clients:
            try:
                res["rcs"][c.name] = c.proc.wait(timeout=DRAIN_TIMEOUT)
            except subprocess.TimeoutExpired:
                res["rcs"][c.name] = "timeout"
        res["learner_alive_at_drain"] = learner.proc.poll() is None
        # the drain: hosts first (their final flush sends the spool tail),
        # then the learner
        for c in children:
            if c is not learner and c.proc.poll() is None:
                c.proc.send_signal(signal.SIGTERM)
        for c in children:
            if c is not learner:
                try:
                    res["rcs"][c.name] = c.proc.wait(timeout=DRAIN_TIMEOUT)
                except subprocess.TimeoutExpired:
                    res["rcs"][c.name] = "timeout"
        if learner.proc.poll() is None:
            learner.proc.send_signal(signal.SIGTERM)
        try:
            res["rcs"]["learner"] = learner.proc.wait(timeout=DRAIN_TIMEOUT)
        except subprocess.TimeoutExpired:
            res["rcs"]["learner"] = "timeout"

        lat, errors, episodes = [], 0, 0
        for c in clients:
            with open(os.path.join(root, f"{c.name}.json")) as f:
                out = json.load(f)
            lat += out["lat"]
            errors += out["errors"]
            episodes += out["episodes"]
        served = np.asarray([d for _, d in lat], np.float64) * 1e3
        res.update({
            "learner": last_stats(learner_stats, "learner"),
            "hosts": [last_stats(p, "serve") for p in host_stats],
            "wall_s": until - t0,
            "requests": len(lat),
            "request_errors": errors,
            "requests_per_s": len(lat) / (until - t0),
            "latency_ms": {q: float(np.percentile(served, q)) if len(served) else None
                           for q in (50, 95, 99)},
            "episodes": episodes,
            "offered_per_s": rate * sessions,
            "logs": {c.name: c.tail(1500) for c in children + clients if c.proc.returncode},
        })
        return res
    finally:
        for c in children + clients:
            if c.proc.poll() is None:
                c.proc.kill()
                c.proc.wait(timeout=30.0)


def pod_failures(res, expected_launches=None):
    """The conditions a pod run broke (empty when it passed). With
    `expected_launches` (one update's kernel launches), every update of the
    learner launched exactly those."""
    bad = []
    lr, hosts = res["learner"], res["hosts"]
    if res["early_exits"]:
        bad.append(f"children exited before the drain: {res['early_exits']}")
    if any(rc != 0 for name, rc in res["rcs"].items() if name != "h0 (killed)"):
        bad.append(f"a child did not drain cleanly: {res['rcs']}")
    if not res["learner_alive_at_drain"]:
        bad.append("the learner died")
    if not res["relaunched_on_same_port"]:
        bad.append("h0 came back on another port")
    if lr.get("ingest_duplicate_blocks", -1) != 0:
        bad.append(f"duplicate blocks {lr.get('ingest_duplicate_blocks')}")
    lost = [h.get("sessions_lost") for h in hosts]
    if any(n != 0 for n in lost):
        bad.append(f"sessions lost {lost}")
    if res["h0_seq_at_kill"] < 1:
        bad.append("h0 delivered no block before the kill")
    if not res["step_at_relaunch"] > res["step_at_kill"]:
        bad.append(f"the learner's step did not advance through the outage "
                   f"({res['step_at_kill']} -> {res['step_at_relaunch']})")
    final_seq = int(lr.get("ingest_host_seq", {}).get("h0", 0))
    if not final_seq > res["h0_seq_at_kill"]:
        bad.append(f"h0's mark did not pass its value at the kill "
                   f"({res['h0_seq_at_kill']} -> {final_seq})")
    # the relaunched h0 numbered past everything before the kill, and every
    # block it numbered reached the learner
    issued = hosts[0].get("transport_next_seq", 0) - 1
    if hosts[0].get("transport_spooled_blocks", 0) < 1 or final_seq != issued:
        bad.append(f"the relaunched h0 spooled {hosts[0].get('transport_spooled_blocks')} "
                   f"blocks up to seq {issued}; the learner's mark for h0 is {final_seq}")
    broadcast = int(lr.get("params_version", 0))
    if lr.get("ingest_ckpts_broadcast", 0) < 1:
        bad.append(f"{lr.get('ingest_ckpts_broadcast')} checkpoints broadcast")
    for i, h in enumerate(hosts):
        if h.get("reloads", 0) < 1:
            bad.append(f"h{i} never reloaded")
        if not 1 <= h.get("params_version", 0) <= broadcast:
            bad.append(f"h{i} installed version {h.get('params_version')}, the learner "
                       f"broadcast 1..{broadcast}")
        if h.get("lstm_launches"):
            bad.append(f"h{i} launched LSTM kernels: {h['lstm_launches']}")
    if expected_launches is not None:
        updates = int(lr.get("learner_updates", 0))
        want = {k: v * updates for k, v in expected_launches.items()}
        shapes = lr.get("launches_per_update")
        if updates < 1 or lr.get("lstm_launches") != want or shapes != [
                {k: float(v) for k, v in expected_launches.items()}]:
            bad.append(f"launches {lr.get('lstm_launches')} over {updates} updates (per "
                       f"update {shapes}), expected {expected_launches} each")
    return bad


# ------------------------------------------------------------ client process


def _clients_main(argv=None) -> int:
    from r2d2_tpu_torch.envs.catch import CatchHostEnv
    from r2d2_tpu_torch.serve import PolicyClient

    p = argparse.ArgumentParser(description="closed-loop catch sessions against pod hosts")
    p.add_argument("--ports", required=True)
    p.add_argument("--sessions", required=True)
    p.add_argument("--rate", type=float, default=25.0)
    p.add_argument("--obs", default="84,84")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    ports = [int(v) for v in args.ports.split(",")]
    height, width = (int(v) for v in args.obs.split(","))
    print(json.dumps({"clients_ready": True}), flush=True)
    t0, until = (float(v) for v in sys.stdin.readline().split())
    window = {"until": until}

    def read_until():
        for line in sys.stdin:
            window["until"] = float(line)

    threading.Thread(target=read_until, daemon=True).start()
    lock = threading.Lock()
    lat, counts = [], {"errors": 0, "episodes": 0}

    def session(idx):
        # a failed request (the outage included) restarts the episode and
        # keeps offering
        rng = np.random.default_rng(idx)
        env = CatchHostEnv(height=height, width=width, seed=idx)
        client = None
        sid = f"pod-{idx}"
        obs, reward, reset = env.reset(), 0.0, True
        while time.time() < window["until"]:
            t_req = time.time()
            try:
                if client is None:
                    client = PolicyClient("127.0.0.1", ports[idx % len(ports)], timeout=5.0,
                                          retries=2, seed=idx)
                out = client.act(sid, obs, reward=reward, reset=reset)
            except Exception:
                with lock:
                    counts["errors"] += 1
                obs, reward, reset = env.reset(), 0.0, True
                time.sleep(min(rng.exponential(1.0 / args.rate), 0.5))
                continue
            with lock:
                lat.append((t_req - t0, time.time() - t_req))
            obs, reward, done, _ = env.step(out["action"])
            reset = bool(done)
            if done:
                with lock:
                    counts["episodes"] += 1
                obs = env.reset()
            time.sleep(rng.exponential(1.0 / args.rate))
        if client is not None:
            client.close()

    time.sleep(max(t0 - time.time(), 0.0))
    threads = [threading.Thread(target=session, args=(int(i),), daemon=True)
               for i in args.sessions.split(",")]
    for th in threads:
        th.start()
    for th in threads:
        while th.is_alive() and time.time() < window["until"] + 30.0:
            th.join(timeout=1.0)
    with open(args.out, "w") as f:
        json.dump({"lat": lat, **counts}, f)
    return 0


if __name__ == "__main__":
    sys.exit(_clients_main())
