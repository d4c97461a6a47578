"""Clients of the serving plane (port of r2d2_tpu/serve/client.py; the
same wire format, so the JAX package's PolicyClient talks to this
serve_tcp and this PolicyClient to the JAX package's).

- `LocalClient`: an in-process blocking wrapper over
  `PolicyServer.submit`, what tests, the chip check's load generator and
  embedded callers use; one instance may be shared by session threads (the
  batcher's queue is the synchronization point).
- `serve_tcp` + `PolicyClient`: a JSON-lines TCP front end for callers in
  other processes (`python -m r2d2_tpu_torch.serve`). One request a line:
  ``{"session": id, "obs": [...], "reward": r, "reset": bool}`` ->
  ``{"action": a, "ckpt_step": s, "params_version": v}`` (``"want_q":
  true`` adds the Q row; ``{"session": id, "cmd": "evict"}`` frees the
  session's cache row on disconnect).
"""

from __future__ import annotations

import json
import socket
import socketserver
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np

from r2d2_tpu_torch.serve.batcher import QueueFullError
from r2d2_tpu_torch.serve.server import ServeResult
from r2d2_tpu_torch.utils.faults import (
    TRANSIENT_ERRORS,
    Backoff,
    fault_point,
    with_retries,
)


class LocalClient:
    """Blocking calls into anything with PolicyServer's submit,
    reset_session and evict."""

    def __init__(self, server, timeout: float = 30.0):
        self.server = server
        self.timeout = timeout

    def act(self, session_id: str, obs, reward: float = 0.0,
            reset: bool = False, epsilon: Optional[float] = None,
            task: int = 0) -> ServeResult:
        """Submit one request and block for its result. Raises what the
        server failed the future with (QueueFullError on overload,
        RuntimeError on a crashed iteration). `epsilon` overrides the
        session's exploration for THIS request (None = server default);
        `task` is the session's task id under multi-task serving."""
        fut = self.server.submit(
            session_id, obs, reward=reward, reset=reset, epsilon=epsilon,
            task=task,
        )
        return fut.result(timeout=self.timeout)

    def reset(self, session_id: str) -> None:
        self.server.reset_session(session_id)

    def evict(self, session_id: str) -> None:
        self.server.evict(session_id)


class _RequestHandler(socketserver.StreamRequestHandler):
    def handle(self) -> None:
        server = self.server.policy_server  # type: ignore[attr-defined]
        for line in self.rfile:
            line = line.strip()
            if not line:
                continue
            try:
                req = json.loads(line)
                if req.get("cmd") == "evict":
                    server.evict(str(req["session"]))
                    resp = {"ok": True}
                else:
                    # host-side JSON decode, no device values in sight
                    obs = np.asarray(req["obs"], np.uint8)
                    eps = req.get("epsilon")
                    # epsilon only when the request carries one: requests
                    # without the field make the exact pre-override call,
                    # so servers exposing the old submit surface still work
                    # r2d2: disable=blocking-host-sync-in-serve-step  (a JSON number)
                    kwargs = {} if eps is None else {"epsilon": float(eps)}
                    fut = server.submit(
                        str(req["session"]), obs,
                        reward=float(req.get("reward", 0.0)),  # r2d2: disable=blocking-host-sync-in-serve-step  (a JSON field of the request)
                        reset=bool(req.get("reset", False)),  # r2d2: disable=blocking-host-sync-in-serve-step  (a JSON field of the request)
                        **kwargs,
                    )
                    result = fut.result(timeout=30.0)
                    resp = {
                        "action": result.action,
                        "ckpt_step": result.ckpt_step,
                        "params_version": result.params_version,
                    }
                    if req.get("want_q"):
                        # result.q is already host numpy (server reads it back)
                        resp["q"] = np.asarray(result.q).tolist()  # r2d2: disable=blocking-host-sync-in-serve-step  (result.q is host numpy)
            except Exception as e:  # answer in-band; keep the stream alive
                resp = {"error": f"{type(e).__name__}: {e}"}
            self.wfile.write((json.dumps(resp) + "\n").encode())
            self.wfile.flush()


class _TCPServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


def serve_tcp(server, host: str = "127.0.0.1",
              port: int = 0) -> Tuple[_TCPServer, threading.Thread]:
    """Start the JSON-lines frontend on (host, port); port 0 picks a free
    one (read it back from ``tcp.server_address``). Returns the live
    socketserver and its acceptor thread; call ``tcp.shutdown()`` then
    ``tcp.server_close()`` to stop."""
    tcp = _TCPServer((host, port), _RequestHandler)
    tcp.policy_server = server  # type: ignore[attr-defined]
    thread = threading.Thread(target=tcp.serve_forever, name="serve-tcp", daemon=True)
    thread.start()
    return tcp, thread


class PolicyClient:
    """Blocking JSON-lines TCP client; one socket, one session stream at a
    time per instance (open one client per concurrent session).

    Transient trouble is retried in the client, not surfaced: socket-level
    errors (reset/refused/closed connections — reconnected between
    attempts) go through the shared `utils/faults.with_retries` backoff
    policy under the `serve.client` fault site, so each retry shows up in
    `retry_stats()` like every other retried boundary. Overload is a
    SEPARATE budget: a full serve queue (`QueueFullError` answered
    in-band) retries up to `queue_retries` times with SEEDED JITTERED
    backoff — a fleet of clients rejected by the same overloaded (or
    freshly killed) replica spreads its retries instead of
    thundering-herding the survivors — then gives up and raises. The
    final error of either budget propagates — retries bound tail latency,
    they do not hide a down or drowning server. `retries=1` /
    `queue_retries=1` restore fail-fast behavior.

    Every give-up is classified in `error_counts` (`rejected` — queue
    budget exhausted; `timeout` — the socket deadline; `transport` —
    every other connection/server failure) so bench rows report WHY
    requests failed, not one lumped count."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 timeout: float = 30.0, retries: int = 3,
                 queue_retries: int = 3, seed: int = 0):
        self.host = host
        self.port = port
        self.timeout = timeout
        self.retries = max(int(retries), 1)
        self.queue_retries = max(int(queue_retries), 1)
        self.seed = seed
        self.error_counts: Dict[str, int] = {
            "rejected": 0, "timeout": 0, "transport": 0,
        }
        self._sock: Optional[socket.socket] = None
        self._rfile = None
        self._connect()

    def _connect(self) -> None:
        self._sock = socket.create_connection(
            (self.host, self.port), timeout=self.timeout
        )
        self._rfile = self._sock.makefile("rb")

    def _disconnect(self) -> None:
        try:
            if self._rfile is not None:
                self._rfile.close()
        except OSError:
            pass
        finally:
            self._rfile = None
        try:
            if self._sock is not None:
                self._sock.close()
        except OSError:
            pass
        finally:
            self._sock = None

    def _attempt(self, payload: dict) -> dict:
        fault_point("serve.client")
        if self._sock is None:
            self._connect()
        try:
            self._sock.sendall((json.dumps(payload) + "\n").encode())
            line = self._rfile.readline()
        except OSError:
            # dead socket: drop it so the next attempt reconnects
            self._disconnect()
            raise
        if not line:
            self._disconnect()
            raise ConnectionError("server closed the connection")
        resp = json.loads(line)
        err = resp.get("error")
        if err is not None:
            # errors travel in-band; re-raise overload as the typed error
            # so the retry policy can tell it from a permanent failure
            if err.startswith("QueueFullError"):
                raise QueueFullError(err)
            raise RuntimeError(err)
        return resp

    def _round_trip(self, payload: dict) -> dict:
        # two nested budgets: the INNER with_retries absorbs transport
        # transients (counted per-site in retry_stats); the OUTER loop is
        # the overload budget — QueueFullError means the server is ALIVE
        # and shedding, so wait a jittered backoff and re-offer, at most
        # queue_retries times. Jitter is seeded per client: a rejected
        # fleet de-synchronizes instead of re-offering in lockstep.
        backoff = Backoff(base=0.01, factor=2.0, max_delay=0.5,
                          jitter=0.5, seed=self.seed)
        for attempt in range(self.queue_retries):
            try:
                return with_retries(
                    lambda: self._attempt(payload),
                    "serve.client",
                    attempts=self.retries,
                    retry_on=TRANSIENT_ERRORS,
                )
            except QueueFullError:
                if attempt == self.queue_retries - 1:
                    self.error_counts["rejected"] += 1
                    raise
                time.sleep(backoff.fail())
            except socket.timeout:
                self.error_counts["timeout"] += 1
                raise
            except TRANSIENT_ERRORS:
                self.error_counts["transport"] += 1
                raise
            except RuntimeError:
                # in-band server-side failure (non-overload)
                self.error_counts["transport"] += 1
                raise

    def act(self, session_id: str, obs, reward: float = 0.0,
            reset: bool = False, want_q: bool = False,
            epsilon: Optional[float] = None) -> dict:
        payload = {
            "session": session_id,
            "obs": np.asarray(obs).tolist(),
            "reward": float(reward),
            "reset": bool(reset),
        }
        if want_q:
            payload["want_q"] = True
        if epsilon is not None:
            payload["epsilon"] = float(epsilon)
        return self._round_trip(payload)

    def evict(self, session_id: str) -> None:
        self._round_trip({"session": session_id, "cmd": "evict"})

    def close(self) -> None:
        self._disconnect()

    def __enter__(self) -> "PolicyClient":
        return self

    def __exit__(self, *exc) -> Optional[bool]:
        self.close()
        return None
