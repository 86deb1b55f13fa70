"""Event bus: the control-plane messaging fabric.

Mirrors the reference's two-tier contract (client_redis.py:93-172,
client_activemq.py:104-169):

- ``send_event_lazy(dest, body)`` — lossy tier: best-effort pub/sub,
  dropped if the transport is down (raw control/voice firehose).
- ``send_event_hopeful(dest, body)`` — durable tier: retried with
  requeue-at-head on failure (completed-call CDRs, metadata updates).
- ``subscribe(dest, callback)`` — callback dispatch through a worker
  pool so slow consumers don't stall the publisher
  (client_redis.py:64-73, 203-244).

Topic vocabulary is kept identical to the reference so operational
tooling ports over: ``/topic/raw_control/<uuid>``,
``/topic/raw_voice/<uuid>``, ``/topic/call_management/new_call/<uuid>``,
``/topic/call_management/timeout/<uuid>``,
``/queue/call_management/call_complete``, ``/queue/metadata/site_update``.

``InProcBus`` is the default transport: every subsystem runs in one
host process per TPU host (the reference needed Redis because each
channel/demod was its own OS process; here the hot path is on-device
and the control plane is one asyncio-ish loop). ``RedisBus`` provides
the same API over a real server for multi-host control planes, gated
on the ``redis`` package.

Messages get the reference's latency headers (``time_queued``/
``time_sent``, client_activemq.py:217-227); deliveries slower than
``latency_warn_s`` are counted and logged.
"""

from __future__ import annotations

import fnmatch
import json
import logging
import queue
import threading
import time
from collections import defaultdict
from typing import Callable

log = logging.getLogger(__name__)


class Subscription:
    __slots__ = ("pattern", "callback")

    def __init__(self, pattern: str, callback: Callable[[dict], None]):
        self.pattern = pattern
        self.callback = callback

    def matches(self, dest: str) -> bool:
        if self.pattern == dest:
            return True
        return fnmatch.fnmatchcase(dest, self.pattern)


class InProcBus:
    """In-process bus with worker-pool dispatch and durable-tier retry."""

    def __init__(self, num_workers: int = 4, latency_warn_s: float = 0.1):
        self._subs: list[Subscription] = []
        self._lock = threading.RLock()
        self._work: queue.Queue = queue.Queue()
        self._hopeful: queue.Queue = queue.Queue()
        self._running = True
        self.latency_warn_s = latency_warn_s
        self.latency_warnings = 0
        self.delivered = 0
        self.dropped = 0
        self._workers = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"bus-worker-{i}")
            for i in range(num_workers)]
        for t in self._workers:
            t.start()
        self._hopeful_thread = threading.Thread(
            target=self._drain_hopeful, daemon=True, name="bus-hopeful")
        self._hopeful_thread.start()

    # -- public API (reference-compatible verbs)
    def subscribe(self, dest: str, callback: Callable[[dict], None]) -> None:
        """``dest`` may contain ``*`` wildcards (fnmatch)."""
        with self._lock:
            self._subs.append(Subscription(dest, callback))

    def unsubscribe(self, dest: str,
                    callback: Callable[[dict], None] | None = None) -> None:
        with self._lock:
            self._subs = [s for s in self._subs
                          if not (s.pattern == dest and
                                  (callback is None or
                                   s.callback is callback))]

    def send_event_lazy(self, dest: str, body: dict,
                        headers: dict | None = None) -> None:
        self._publish(dest, body, headers, durable=False)

    def send_event_hopeful(self, dest: str, body: dict,
                           headers: dict | None = None) -> None:
        self._publish(dest, body, headers, durable=True)

    def close(self) -> None:
        self._running = False

    def flush(self, timeout: float = 5.0) -> bool:
        """Block until every queued event (including cascades published
        from inside callbacks) has been dispatched. Offline decode uses
        this to make event ordering deterministic w.r.t. block
        processing; live capture never calls it."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            if self._work.unfinished_tasks == 0 and self._hopeful.empty():
                return True
            time.sleep(0.001)
        return False

    # -- internals
    def _publish(self, dest: str, body: dict, headers: dict | None,
                 durable: bool) -> None:
        msg = {"destination": dest, "body": body,
               "headers": dict(headers or {})}
        msg["headers"].setdefault("time_queued", time.time())
        if durable:
            self._hopeful.put(msg)
        else:
            self._dispatch(msg)

    def _dispatch(self, msg: dict) -> None:
        msg["headers"]["time_sent"] = time.time()
        with self._lock:
            subs = [s for s in self._subs if s.matches(msg["destination"])]
        if not subs:
            self.dropped += 1
            return
        for s in subs:
            self._work.put((s, msg))

    def _worker(self) -> None:
        while self._running:
            try:
                s, msg = self._work.get(timeout=0.5)
            except queue.Empty:
                continue
            lat = time.time() - msg["headers"]["time_queued"]
            if lat > self.latency_warn_s:
                self.latency_warnings += 1
                log.warning("bus latency %.3fs on %s", lat,
                            msg["destination"])
            try:
                s.callback(msg["body"])
                self.delivered += 1
            except Exception:
                log.exception("subscriber error on %s", msg["destination"])
            finally:
                self._work.task_done()

    def _drain_hopeful(self) -> None:
        """Durable tier: requeue-at-head on failure, like the reference's
        hopeful queues (client_redis.py:140-152)."""
        pending: list[dict] = []
        while self._running:
            if not pending:
                try:
                    pending.append(self._hopeful.get(timeout=0.5))
                except queue.Empty:
                    continue
            msg = pending[0]
            try:
                self._dispatch(msg)
                pending.pop(0)
            except Exception:
                log.exception("hopeful dispatch failed; retrying")
                time.sleep(0.5)


class RedisBus:
    """Same API over the Redis wire protocol for multi-host control
    planes — built on the in-repo stdlib RESP client (control.resp), so
    it speaks to a real Redis in production and to
    ``resp.MiniRedisServer`` in tests without any package dependency.

    Reference semantics preserved (client_redis.py):
    - JSON bodies on the wire with latency headers (129-131, 218-228);
    - multi-server publish-to-all / subscribe-to-all
      (redis_channelizer_manager.py:44-46);
    - **reconnect-requeue** on the durable tier: a failed hopeful send
      is requeued at the *head* and retried by the drain thread after
      reconnect (client_redis.py:140-152); the lossy tier drops;
    - subscriber connections re-subscribe everything on reconnect
      (client_redis.py:74-92 handled inside RespPubSub).
    """

    def __init__(self, servers: list[dict] | None = None,
                 latency_warn_s: float = 0.1,
                 retry_s: float = 0.25):
        from radiocapture_tpu_torch.control.resp import RespClient, RespPubSub
        servers = servers or [{}]
        self._clients = [RespClient(host=s.get("host", "localhost"),
                                    port=s.get("port", 6379))
                         for s in servers]
        self._pubsubs = [RespPubSub(host=s.get("host", "localhost"),
                                    port=s.get("port", 6379),
                                    reconnect_s=retry_s)
                         for s in servers]
        self._running = True
        self.latency_warn_s = latency_warn_s
        self.latency_warnings = 0
        self.connection_issue = False
        self.retry_s = retry_s
        # [(dest, data, pending-client-indices)] — per-server success is
        # tracked so a retry after a partial failure only hits the
        # servers that failed (no duplicate durable queue entries).
        self._hopeful: list[tuple[str, str, set[int]]] = []
        self._hopeful_cv = threading.Condition()
        self._inflight = 0          # popped but not yet fully published
        self._cb_map: dict = {}
        self._drain = threading.Thread(target=self._drain_hopeful,
                                       daemon=True, name="redisbus-drain")
        self._drain.start()

    # ---- subscribe side
    def subscribe(self, dest: str, callback: Callable[[dict], None]) -> None:
        def on_msg(_chan: str, data: bytes, cb=callback):
            try:
                body = json.loads(data)
            except Exception:
                return
            hdr = body.pop("_headers", {})
            tq = hdr.get("time_queued")
            if tq and time.time() - tq > self.latency_warn_s:
                self.latency_warnings += 1
            cb(body)
        self._cb_map[(dest, callback)] = on_msg
        for ps in self._pubsubs:
            ps.psubscribe(dest, on_msg)

    def unsubscribe(self, dest: str,
                    callback: Callable[[dict], None] | None = None) -> None:
        for (d, cb), wrapped in list(self._cb_map.items()):
            if d == dest and (callback is None or cb is callback):
                for ps in self._pubsubs:
                    ps.punsubscribe(dest, wrapped)
                del self._cb_map[(d, cb)]

    # ---- publish side
    @staticmethod
    def _payload(body: dict, headers: dict | None) -> str:
        payload = dict(body)
        payload["_headers"] = {"time_queued": time.time(),
                               **(headers or {})}
        return json.dumps(payload)

    def send_event_lazy(self, dest: str, body: dict,
                        headers: dict | None = None) -> None:
        data = self._payload(body, headers)
        for c in self._clients:
            try:
                c.publish(dest, data)
            except ConnectionError:
                self.connection_issue = True   # lossy tier: drop

    def send_event_hopeful(self, dest: str, body: dict,
                           headers: dict | None = None) -> None:
        with self._hopeful_cv:
            self._hopeful.append((dest, self._payload(body, headers),
                                  set(range(len(self._clients)))))
            self._hopeful_cv.notify()

    def _drain_hopeful(self) -> None:
        while self._running:
            with self._hopeful_cv:
                if not self._hopeful:
                    self._hopeful_cv.wait(timeout=0.5)
                    continue
                dest, data, pending = self._hopeful.pop(0)
                self._inflight += 1
            failed = False
            for i in sorted(pending):
                try:
                    c = self._clients[i]
                    c.publish(dest, data)
                    # durable copy under a list key for pull consumers
                    c.rpush("queue:" + dest, data)
                    pending.discard(i)
                except Exception:
                    # ConnectionError OR server-side RespError (MISCONF,
                    # LOADING, ...): the drain thread must never die —
                    # that would silently disable the durable tier
                    # forever. Requeue and back off instead.
                    failed = True
            if not failed:
                self.connection_issue = False
                with self._hopeful_cv:
                    self._inflight -= 1
            else:
                # requeue at HEAD and back off (client_redis.py:140-152);
                # only the still-pending servers are retried.
                self.connection_issue = True
                log.warning("hopeful publish to %s failed on %d "
                            "server(s); retrying", dest, len(pending))
                with self._hopeful_cv:
                    self._hopeful.insert(0, (dest, data, pending))
                    self._inflight -= 1
                time.sleep(self.retry_s)

    def flush(self, timeout: float = 5.0) -> bool:
        deadline = time.time() + timeout
        while time.time() < deadline:
            with self._hopeful_cv:
                if not self._hopeful and self._inflight == 0:
                    return True
            time.sleep(0.01)
        return False

    def close(self) -> None:
        self._running = False
        for ps in self._pubsubs:
            ps.close()
        for c in self._clients:
            c.close()


class DualBus:
    """The reference's actual broker topology: Redis pub/sub for the
    lossy ``/topic/*`` firehose AND ActiveMQ/STOMP for the durable
    ``/queue/*`` tier — every reference process takes *both* clients
    (call_recorder.py:81-108 passes client_redis and client_activemq
    side by side). Routes by destination prefix; ``send_event_hopeful``
    always goes to the durable broker."""

    def __init__(self, lazy_bus, durable_bus):
        self.lazy = lazy_bus
        self.durable = durable_bus

    @staticmethod
    def _is_queue(dest: str) -> bool:
        return dest.startswith("/queue/") or dest.startswith("queue:")

    def send_event_lazy(self, dest, body, headers=None):
        (self.durable if self._is_queue(dest) else self.lazy) \
            .send_event_lazy(dest, body, headers)

    def send_event_hopeful(self, dest, body, headers=None):
        self.durable.send_event_hopeful(dest, body, headers)

    def subscribe(self, dest, callback):
        (self.durable if self._is_queue(dest) else self.lazy) \
            .subscribe(dest, callback)

    def unsubscribe(self, dest, callback=None):
        (self.durable if self._is_queue(dest) else self.lazy) \
            .unsubscribe(dest, callback)

    def flush(self, timeout: float = 5.0) -> bool:
        ok = True
        for b in (self.lazy, self.durable):
            if hasattr(b, "flush"):
                ok = b.flush(timeout) and ok
        return ok

    @property
    def connection_issue(self) -> bool:
        return bool(getattr(self.lazy, "connection_issue", False)
                    or getattr(self.durable, "connection_issue", False))

    def close(self):
        self.lazy.close()
        self.durable.close()


def make_bus(redis_servers: list[dict] | None = None,
             activemq: dict | None = None):
    """Broker topology from config: Redis topics + optional STOMP
    durable tier (the reference's dual-client layout); InProcBus when
    nothing is configured. Connections are lazy with reconnect, so
    not-yet-up brokers are fine."""
    lazy = RedisBus(redis_servers) if redis_servers else InProcBus()
    if activemq:
        from radiocapture_tpu_torch.control.stomp import StompBus
        durable = StompBus(activemq.get("host", "localhost"),
                           activemq.get("port", 61613))
        return DualBus(lazy, durable)
    return lazy
