"""Port parity, supervision (L7): the port's copies of the frontend
control server and client, the supervisor, the watchdog channel and
device discovery, checked as ``tests/test_supervision.py`` checks the
JAX package's — the frontend's wire protocol on the port's
``ChannelScheduler`` (with and without sockets), a dead worker
restarted, the watchdog's status/uptime/restart verbs, and the device
table published to the port's presence store. Every wait has a
deadline."""

import time

import pytest

from radiocapture_tpu.frontend import server as JS
from radiocapture_tpu.frontend.scheduler import \
    ChannelScheduler as JChannelScheduler
from radiocapture_tpu_torch.control.overseer import (Supervisor,
                                                     WatchdogClient,
                                                     WatchdogService)
from radiocapture_tpu_torch.control.presence import PresenceStore
from radiocapture_tpu_torch.frontend.device_discovery import (
    DeviceDiscovery, enumerate_configured)
from radiocapture_tpu_torch.frontend.scheduler import ChannelScheduler
from radiocapture_tpu_torch.frontend.server import (FrontendConnector,
                                                    FrontendServer)

WAIT_S = 5.0
REQUESTS = ["connect", "create,0,25000,857500000", "hb,0", "hb,99",
            "offset,0,{bid},150.0", "create,0,25000,857600000",
            "release,0,{bid}", "release,0,{bid}", "create,0,25000,999000000",
            "scan_mode_set_freq,860000000", "bogus", "quit,0"]


def _handler(server_cls, sched):
    srv = server_cls.__new__(server_cls)          # no socket bind
    srv.scheduler = sched
    srv._client_num = 0
    srv.on_scan_set_freq = None
    return srv


def _wait(cond, timeout=WAIT_S):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return False


def test_wire_protocol_handler_as_jax():
    """The CSV verbs give the same replies from the port's handler on the
    port's scheduler as from the JAX handler on the JAX scheduler, and
    leave the same slot and AFC state."""
    t = [1000.0]
    port = _handler(FrontendServer, ChannelScheduler(
        {0: (857.0e6, 2.4e6)}, num_slots=8, now_fn=lambda: t[0]))
    ref = _handler(JS.FrontendServer, JChannelScheduler(
        {0: (857.0e6, 2.4e6)}, num_slots=8, now_fn=lambda: t[0]))
    bid = None
    for req in REQUESTS:
        msg = req.format(bid=bid)
        got, want = port.handle(msg), ref.handle(msg)
        assert got == want, msg
        if msg.startswith("create") and got.startswith("create,") \
                and bid is None:
            bid = got.split(",")[1]
    assert bid is not None
    assert port.scheduler.sources[0].afc_offset == 150.0
    assert port.scheduler.sources[0].center_freq == 860000000
    assert port.scheduler.stats() == ref.scheduler.stats()


def test_frontend_server_client_zmq():
    """Full socket path: connect, create, heartbeats keep the client
    alive, AFC offset, release (frontend_connector.py:127-229)."""
    sched = ChannelScheduler({0: (857.0e6, 2.4e6)}, num_slots=8)
    srv = FrontendServer(sched, bind="tcp://127.0.0.1:0").start()
    conn = None
    try:
        conn = FrontendConnector("tcp://127.0.0.1:%s" % srv.port)
        got = conn.create_channel(25000, 857_500_000)
        assert got is not None
        block_id, slot = got
        assert sched.active_mask(0)[slot]
        assert conn.report_offset(block_id, 42.0)
        assert sched.sources[0].afc_offset == 42.0
        time.sleep(0.6)      # a couple of heartbeat periods
        assert sched.stats()["clients"] >= 1
        assert conn.release_channel(block_id)
        assert not sched.active_mask(0)[slot]
        assert conn.create_channel(25000, 999_000_000) is None
    finally:
        if conn is not None:
            conn.quit()
        srv.stop()


def _crashy_worker():
    raise SystemExit(1)


def _sleepy_worker():
    time.sleep(60)


def test_supervisor_restarts_dead_worker():
    sup = Supervisor()
    sup.add("crashy", _crashy_worker)
    sup.add("sleepy", _sleepy_worker)
    sup.add("once", _crashy_worker, restart=False)
    sup.POLL_S = 0.2
    sup.start()
    try:
        assert _wait(lambda: sup.workers["crashy"].restarts >= 1)
        ups = sup.uptimes()
        assert ups["sleepy"] >= 0
        assert sup.workers["once"].restarts == 0
    finally:
        sup.stop()
    assert not any(w.process.is_alive() for w in sup.workers.values())


def test_watchdog_channel():
    sup = Supervisor()
    sup.add("sysA", _sleepy_worker)
    sup.POLL_S = 0.2
    sup.start()
    quality = {"sysA": [0.9, 1.0]}
    svc = WatchdogService(sup, get_quality=lambda n: quality.get(n, []),
                          port=0).start()
    try:
        cli = WatchdogClient(port=svc.port)
        assert cli.all_get_status() == {"sysA": 1.0}
        assert cli.all_get_status_avg() == {"sysA": pytest.approx(0.95)}
        assert cli.all_get_uptime()["sysA"] >= 0
        assert cli.send_message({"action": "NOPE"})["fail"] is True
        assert cli.sweep_restart_old() == []
        sup.workers["sysA"].start_time -= 90000      # a day old
        assert cli.sweep_restart_old() == ["sysA"]
        assert sup.workers["sysA"].restarts == 1
    finally:
        svc.stop()
        sup.stop()


def test_device_discovery_publishes_table():
    store = PresenceStore()
    sources = {0: {"type": "file", "args": "iq.dat",
                   "center_freq": 857e6, "samp_rate": 2.4e6},
               1: {"type": "rtlsdr", "args": "rtl_tcp=127.0.0.1:1234",
                   "center_freq": 859.4e6, "samp_rate": 2.4e6}}
    dd = DeviceDiscovery(store, sources=sources, host="testhost")
    t = dd.publish_once()
    assert t["host"] == "testhost"
    types = [d["type"] for d in t["devices"]]
    assert "file" in types and "rtlsdr" in types
    assert dd.host_hash in store.live("device_table", ttl=5.0)
    cfg = enumerate_configured(sources)
    assert [c["samp_rate"] for c in cfg] == [2.4e6, 2.4e6]
    dd.PERIOD_S = 0.05
    dd.start()
    try:
        first = store.live("device_table", ttl=5.0)[dd.host_hash]["time"]
        assert _wait(lambda: store.live("device_table", ttl=5.0)[
            dd.host_hash]["time"] > first)
    finally:
        dd.stop()
    assert not dd._thread.is_alive()
