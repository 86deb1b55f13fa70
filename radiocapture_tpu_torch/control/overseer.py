"""Backend supervision: process supervisor + watchdog service/client.

Replaces the reference's L7 (SURVEY.md §1):

- ``overseer.py:51-128``: the backend master spawns one OS process per
  configured system demod, per-protocol call managers, and the call
  recorder manager via ``multiprocessing.Process``, polls ``is_alive()``
  every 5 s, and an excepthook terminates all children on a master
  crash. Here :class:`Supervisor` manages named workers with the same
  liveness loop plus optional restart (the reference delegates restart
  to systemd ``Restart=always``; embedded restart keeps dev deployments
  self-healing without systemd).

- ``watchdog.py``: a REQ/REP zlib-JSON status channel —
  ``ALL_GET_STATUS`` (latest quality per system), ``ALL_GET_STATUS_AVG``,
  ``ALL_GET_UPTIME``, ``RESTART_RECEIVER`` — and the client loop that
  restarts any receiver with uptime > 86400 s (watchdog.py:85-107).
"""

from __future__ import annotations

import json
import logging
import multiprocessing as mp
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Callable

log = logging.getLogger(__name__)


@dataclass
class Worker:
    name: str
    target: Callable
    args: tuple = ()
    process: mp.Process | None = None
    start_time: float = 0.0
    restarts: int = 0
    restart: bool = True


class Supervisor:
    """Spawn + monitor named worker processes (overseer.py:76-128)."""

    POLL_S = 5.0

    def __init__(self, restart: bool = True):
        self.workers: dict[str, Worker] = {}
        self.restart_default = restart
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def add(self, name: str, target: Callable, args: tuple = (),
            restart: bool | None = None) -> None:
        self.workers[name] = Worker(
            name=name, target=target, args=args,
            restart=self.restart_default if restart is None else restart)

    def start(self) -> "Supervisor":
        for w in self.workers.values():
            self._spawn(w)
        self._thread = threading.Thread(target=self._monitor, daemon=True)
        self._thread.start()
        return self

    def _spawn(self, w: Worker) -> None:
        w.process = mp.Process(target=_worker_main,
                               args=(w.name, w.target, w.args),
                               name=w.name, daemon=True)
        w.process.start()
        w.start_time = time.time()
        log.info("spawned %s pid=%s", w.name, w.process.pid)

    def _monitor(self) -> None:
        while not self._stop.wait(self.POLL_S):
            alive = 0
            for w in self.workers.values():
                if w.process is not None and w.process.is_alive():
                    alive += 1
                elif not self._stop.is_set() and w.restart:
                    log.error("%s died (exit %s); restarting", w.name,
                              w.process.exitcode if w.process else None)
                    w.restarts += 1
                    self._spawn(w)
            log.info("System Status: %d/%d workers alive", alive,
                     len(self.workers))

    def restart_worker(self, name: str) -> bool:
        w = self.workers.get(name)
        if w is None:
            return False
        if w.process is not None and w.process.is_alive():
            w.process.terminate()
            w.process.join(timeout=5.0)
        w.restarts += 1
        self._spawn(w)
        return True

    def uptimes(self) -> dict[str, float]:
        now = time.time()
        return {n: (now - w.start_time if w.process is not None
                    and w.process.is_alive() else -1)
                for n, w in self.workers.items()}

    def stop(self) -> None:
        """Terminate every child (the reference excepthook semantics,
        overseer.py:43-48)."""
        self._stop.set()
        # Quiesce the monitor first so it can't respawn (or swap the
        # process object) while we tear children down.
        if self._thread is not None:
            self._thread.join(timeout=2 * self.POLL_S + 5.0)
        for w in self.workers.values():
            if w.process is not None and w.process.is_alive():
                w.process.terminate()
        for w in self.workers.values():
            if w.process is not None:
                try:
                    w.process.join(timeout=5.0)
                except (AssertionError, ValueError):
                    pass


def _worker_main(name: str, target: Callable, args: tuple) -> None:
    """Child entry: label the process then run (overseer.py:113
    setproctitle; optional here)."""
    try:
        import setproctitle
        setproctitle.setproctitle("rc-tpu: %s" % name)
    except ImportError:
        pass
    target(*args)


class WatchdogService:
    """REP side of the watchdog channel. ``get_status(name) -> list``
    supplies each system's quality ring (demod engines' ``quality``)."""

    def __init__(self, supervisor: Supervisor,
                 get_quality: Callable[[str], list] | None = None,
                 port: int = 50002, bind_host: str = "127.0.0.1"):
        import zmq
        self.sup = supervisor
        self.get_quality = get_quality or (lambda name: [])
        self.ctx = zmq.Context.instance()
        self.sock = self.ctx.socket(zmq.REP)
        if port == 0:
            self.port = self.sock.bind_to_random_port(
                "tcp://%s" % bind_host)
        else:
            self.sock.bind("tcp://%s:%s" % (bind_host, port))
            self.port = port
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def handle(self, msg: dict) -> dict:
        resp: dict = {}
        action = msg.get("action")
        names = list(self.sup.workers)
        if action == "ALL_GET_STATUS":
            resp["data"] = {}
            for n in names:
                q = self.get_quality(n)
                resp["data"][n] = q[-1] if q else -1
        elif action == "ALL_GET_STATUS_AVG":
            resp["data"] = {}
            for n in names:
                q = self.get_quality(n)
                resp["data"][n] = (sum(q) / len(q)) if q else -1
        elif action == "ALL_GET_UPTIME":
            resp["data"] = self.sup.uptimes()
        elif action == "RESTART_RECEIVER":
            resp["data"] = self.sup.restart_worker(msg.get("system", ""))
        else:
            resp["fail"] = True
            resp["data"] = "UNKNOWN ACTION"
        return resp

    def _loop(self) -> None:
        while not self._stop.is_set():
            if self.sock.poll(100):
                raw = self.sock.recv()
                try:
                    msg = json.loads(zlib.decompress(raw))
                    resp = self.handle(msg)
                except Exception as e:
                    resp = {"fail": True, "data": str(e)}
                self.sock.send(zlib.compress(json.dumps(resp).encode()))

    def start(self) -> "WatchdogService":
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        self.sock.close(0)


class WatchdogClient:
    """REQ side (watchdog.py:10-84): zlib-compressed JSON, 1 s budget."""

    MAX_UPTIME_S = 86400.0    # restart threshold (watchdog.py:100-103)

    def __init__(self, host: str = "127.0.0.1", port: int = 50002):
        import zmq
        self._zmq = zmq
        self.ctx = zmq.Context.instance()
        self.sock = self.ctx.socket(zmq.REQ)
        self.sock.setsockopt(zmq.LINGER, 0)
        self.sock.setsockopt(zmq.RCVTIMEO, 1000)
        self.sock.setsockopt(zmq.SNDTIMEO, 1000)
        self.sock.connect("tcp://%s:%s" % (host, port))

    def send_message(self, msg: dict):
        try:
            self.sock.send(zlib.compress(json.dumps(msg).encode()))
            return json.loads(zlib.decompress(self.sock.recv()))
        except self._zmq.Again:
            return {"data": "Timeout"}

    def all_get_status(self):
        return self.send_message({"action": "ALL_GET_STATUS"})["data"]

    def all_get_status_avg(self):
        return self.send_message({"action": "ALL_GET_STATUS_AVG"})["data"]

    def all_get_uptime(self):
        return self.send_message({"action": "ALL_GET_UPTIME"})["data"]

    def restart_receiver(self, system: str):
        return self.send_message({"action": "RESTART_RECEIVER",
                                  "system": system})["data"]

    def sweep_restart_old(self) -> list[str]:
        """One pass of the reference's main loop: restart every receiver
        older than a day (watchdog.py:92-107)."""
        uptimes = self.all_get_uptime()
        restarted = []
        if uptimes == "Timeout":
            return restarted
        for name, up in uptimes.items():
            if isinstance(up, (int, float)) and up > self.MAX_UPTIME_S:
                self.restart_receiver(name)
                restarted.append(name)
        return restarted
