"""Port parity, live SDR ingest: the port's rtl_tcp and rciq clients and
servers (copies of the JAX package's, on the port's ingest ring) checked
as ``tests/test_rtl_tcp.py`` and ``tests/test_rciq.py`` check the JAX
ones — handshake and configuration, reconnects, the format mismatch —
then the port's ``SiteRuntime(device="cpu")`` and the JAX one consuming
the same rtl_tcp (bf16 wire) and rciq (float32 wire) streams through
``providers_from_config``, and a mixed bf16/float32 group stacked as JAX
stacks it.

The streams are faster than real time and every runtime starts once its
ring holds all the blocks it will step, so the paced providers never wait
and the JAX providers never zero-fill: both runtimes see the same samples.
Every wait on a socket or a thread has a deadline, so a stuck peer fails
the test instead of hanging the suite."""

import time

import ml_dtypes
import numpy as np
import pytest
import torch

from radiocapture_tpu import runtime as JRT
from radiocapture_tpu import rxconfig as JRX
from radiocapture_tpu_torch import runtime as TRT
from radiocapture_tpu_torch import rxconfig as TRX
from radiocapture_tpu_torch.frontend import rciq as Q
from radiocapture_tpu_torch.frontend import rtl_tcp as R
from radiocapture_tpu_torch.testing import streams
from test_torch_ingest import place_jax_ring_library

torch.set_num_threads(1)   # six test workers share the machine


@pytest.fixture(autouse=True)
def _isolate_port_vocoder(monkeypatch):
    """A port ``SiteRuntime`` installs the port recorder's process-global
    default vocoder, which carries decoder state: put back whatever was
    there after each test, as ``tests/conftest.py`` does for the JAX
    package's."""
    from radiocapture_tpu_torch.audio import recorder
    monkeypatch.setattr(recorder, "_default_vocoder",
                        recorder.get_default_vocoder())


SAMP, CENTER, CC = 2.4e6, 857.0e6, 857.5e6
BLOCK_S = 0.05
N_BLOCKS = 20              # 1 s of stream: ~15 IDEN_UP/grant pairs
FAST = 10.0                # the fake rtl_tcp daemon's pace, × real time
WAIT_S = 10.0
RUNTIMES = {"jax": (JRT, JRX), "torch": (TRT, TRX)}


@pytest.fixture(autouse=True, scope="module")
def _jax_ring_library():
    place_jax_ring_library()


def _wait(cond, timeout=WAIT_S):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return False


# ------------------------------------------------------------ rtl_tcp
def test_rtl_tcp_parse_addr_forms():
    assert R.parse_addr("rtl_tcp=10.0.0.5:2000") == ("10.0.0.5", 2000)
    assert R.parse_addr("10.0.0.5:2000") == ("10.0.0.5", 2000)
    assert R.parse_addr("sdrhost") == ("sdrhost", 1234)
    assert R.parse_addr("rtl=2") == ("127.0.0.1", 1236)
    assert R.parse_addr("", index=3) == ("127.0.0.1", 1237)


def test_rtl_tcp_handshake_configure_and_stream():
    """The client reads the header, configures the dongle (rate, freq,
    ppm, manual gain), streams cu8 into the port's ring within the
    quantization error, and its AFC retune reaches the server."""
    rng = np.random.default_rng(0)
    iq = (rng.uniform(-0.7, 0.7, 4096)
          + 1j * rng.uniform(-0.7, 0.7, 4096)).astype(np.complex64)
    srv = R.FakeRtlTcpServer(iq, samp_rate=1.2e6)
    src = R.RtlTcpSource(srv.host, srv.port, samp_rate=1.2e6,
                         center_freq=857_000_000, ppm=12,
                         gain_tenth_db=297)
    try:
        assert _wait(lambda: src.ring.available >= 4096)
        assert src.tuner_type == 5 and src.tuner_gain_count == 29
        assert _wait(lambda: len(srv.commands) >= 5)
        cmds = dict(srv.commands)
        assert cmds[R.CMD_SET_SAMP_RATE] == 1_200_000
        assert cmds[R.CMD_SET_FREQ] == 857_000_000
        assert cmds[R.CMD_SET_FREQ_CORRECTION] == 12
        assert cmds[R.CMD_SET_GAIN_MODE] == 1
        assert cmds[R.CMD_SET_GAIN] == 297
        blk = src.ring.pop(4096)
        assert np.max(np.abs(blk[:, 0] + 1j * blk[:, 1] - iq)) < 1.5 / 127.5
        bits = src.provider(bf16="auto")(1024)
        assert bits.dtype == np.uint16 and bits.shape == (1024, 2)
        src.set_center_freq(857_000_400)
        assert _wait(lambda: (R.CMD_SET_FREQ, 857_000_400) in srv.commands)
    finally:
        src.stop()
        srv.close()


def test_rtl_tcp_reconnects_and_reconfigures():
    srv = R.FakeRtlTcpServer(np.zeros(2048, np.complex64))
    src = R.RtlTcpSource(srv.host, srv.port, samp_rate=2.4e6,
                         center_freq=851_000_000, reconnect_s=0.05)
    try:
        assert _wait(lambda: src.connects == 1)
        n_cmds = len(srv.commands)
        srv.drop_connections()
        assert _wait(lambda: src.connects >= 2), "no reconnect"
        assert _wait(lambda: len(srv.commands) > n_cmds)
        assert (R.CMD_SET_FREQ, 851_000_000) in srv.commands[n_cmds:]
    finally:
        src.stop()
        srv.close()
    assert not src._thread.is_alive()


# --------------------------------------------------------------- rciq
NOTHING = np.zeros(0, np.complex64)


def _commands(srv) -> list:
    """The commands the server has read: it reads them when it
    broadcasts, so broadcast nothing first."""
    srv.broadcast(NOTHING)
    return srv.commands


def _feed(srv, iq, rings, need, chunk=32768):
    """Broadcast ``iq`` (looped) from its start until every ring holds
    ``need`` samples: the driver host's send loop, as fast as the
    clients read."""
    pos, deadline = 0, time.time() + WAIT_S
    while min(r.available for r in rings) < need:
        assert time.time() < deadline, "rciq clients did not fill"
        blk = np.take(iq, np.arange(pos, pos + chunk), mode="wrap")
        srv.broadcast(blk)
        pos = (pos + chunk) % len(iq)


def test_rciq_parse_args_forms():
    assert Q.parse_args("rciq=10.0.0.5:2000") == ("10.0.0.5", 2000, "cs16")
    assert Q.parse_args("10.0.0.5:2000,fmt=cf32") == ("10.0.0.5", 2000,
                                                      "cf32")
    assert Q.parse_args("sdrhost") == ("sdrhost", Q.DEFAULT_PORT, "cs16")
    assert Q.parse_args("", index=3) == ("127.0.0.1", Q.DEFAULT_PORT + 3,
                                         "cs16")
    with pytest.raises(ValueError):
        Q.parse_args("host:1,fmt=cu8")


def test_rciq_handshake_configure_and_stream():
    """The client checks the header, sends rate, tune and gain, streams
    cs16 into the port's ring within the quantization error, and its AFC
    retune reaches the driver host."""
    rng = np.random.default_rng(0)
    iq = (rng.uniform(-0.7, 0.7, 8192)
          + 1j * rng.uniform(-0.7, 0.7, 8192)).astype(np.complex64)
    srv = Q.RcIqServer(8e6, 857e6, fmt="cs16")
    src = Q.RcIqSource(srv.host, srv.port, samp_rate=8e6,
                       center_freq=857_000_000.0, fmt="cs16",
                       gains={"RF": 30})
    try:
        assert _wait(lambda: srv.clients == 1)
        _feed(srv, iq, [src.ring], 8192, chunk=8192)
        assert src.server_rate == 8e6 and src.server_freq == 857e6
        assert _wait(lambda: len(_commands(srv)) >= 3)
        by_cmd = {c["cmd"]: c for c in srv.commands}
        assert by_cmd["rate"]["hz"] == 8e6
        assert by_cmd["tune"]["hz"] == 857_000_000.0
        assert by_cmd["gain"] == {"cmd": "gain", "db": 30.0, "name": "RF"}
        blk = src.ring.pop(8192)
        assert np.max(np.abs(blk[:, 0] + 1j * blk[:, 1] - iq)) < 2.0 / 32767
        src.set_center_freq(857_000_400.0)
        assert _wait(lambda: _commands(srv)
                     and srv.center_freq == 857_000_400.0)
    finally:
        src.stop()
        srv.close()


def test_rciq_format_mismatch_refused():
    srv = Q.RcIqServer(8e6, 857e6, fmt="cf32")
    src = Q.RcIqSource(srv.host, srv.port, samp_rate=8e6,
                       center_freq=857e6, fmt="cs16", reconnect_s=0.05)
    try:
        time.sleep(0.5)
        assert src.connects == 0      # handshake rejected, no stream
    finally:
        src.stop()
        srv.close()


def test_rciq_reconnects_and_reconfigures():
    srv = Q.RcIqServer(10e6, 851e6, fmt="cs16")
    src = Q.RcIqSource(srv.host, srv.port, samp_rate=10e6,
                       center_freq=851_000_000.0, fmt="cs16",
                       reconnect_s=0.05)
    try:
        assert _wait(lambda: src.connects == 1)
        assert _wait(lambda: len(_commands(srv)) >= 2)
        n_cmds = len(srv.commands)
        srv.drop_connections()
        assert _wait(lambda: src.connects >= 2), "no reconnect"
        assert _wait(lambda: len(_commands(srv)) > n_cmds)
        assert any(c.get("cmd") == "tune" and c.get("hz") == 851_000_000.0
                   for c in srv.commands[n_cmds:])
    finally:
        src.stop()
        srv.close()
    assert not src._thread.is_alive()


# ------------------------------------------- runtimes on live streams
def _config(rx, tmp_path, kind, args):
    cfg = rx.RcConfig()
    cfg.audio_dir = str(tmp_path / "audio")
    cfg.num_slots_per_source = 8
    cfg.block_seconds = BLOCK_S
    cfg.sources[0] = rx.SourceConfig(type=kind, args=args,
                                     center_freq=CENTER, samp_rate=SAMP)
    cfg.systems[0] = rx.SystemConfig(type="p25", id="LiveSys",
                                     control_channels=[CC])
    return cfg


def _decode(which, cfg, fill):
    """Providers from ``cfg``; ``fill(live)`` streams until the rings
    hold N_BLOCKS; then N_BLOCKS runtime steps on the stream clock.
    Returns (the control messages, the runtime, the live sources)."""
    rt_mod = RUNTIMES[which][0]
    providers, live = rt_mod.providers_from_config(cfg)
    rt = None
    try:
        assert len(live) == 1
        kw = {"device": "cpu"} if which == "torch" else {}
        rt = rt_mod.SiteRuntime(cfg, providers, **kw)
        fill(live, N_BLOCKS * rt.block_len(0))
        rt.use_stream_clock()
        msgs = []
        rt.bus.subscribe("/topic/raw_control/*", msgs.append)
        rt.run(n_blocks=N_BLOCKS)
        rt.bus.flush()
    finally:
        if rt is not None:
            rt.close()
        for s in live:
            s.stop()
    return msgs, rt, live


def _grants(msgs, group):
    return [m for m in msgs if m.get("name") == "GRP_V_CH_GRANT"
            and m.get("crc") == 0 and m["Group Address"] == group]


def test_runtimes_decode_the_same_rtl_tcp_stream(tmp_path):
    """An rtl_tcp source (cu8; ``ingest_bf16`` hands bf16 blocks, uint16
    bits in the port): the port's runtime on the CPU and the JAX runtime
    decode the same control messages, grant included, from the same
    stream."""
    wide = streams.live_control("C4FM", group=900, source=45)
    srv = R.FakeRtlTcpServer(wide, samp_rate=FAST * SAMP, realtime=True)

    def fill(live, need):
        assert _wait(lambda: live[0].ring.available >= need)
    try:
        runs = {w: _decode(w, _config(rx, tmp_path / w, "rtlsdr",
                                      f"rtl_tcp={srv.host}:{srv.port}"),
                           fill)
                for w, (_m, rx) in RUNTIMES.items()}
    finally:
        srv.close()
    (got, rt, live), (want, _, _) = runs["torch"], runs["jax"]
    assert (R.CMD_SET_FREQ, int(CENTER)) in srv.commands
    assert _grants(got, 900), f"{len(got)} control messages"
    assert got == want
    assert {g["in_dtype"] for g in rt.groups.values()} == {np.dtype(np.uint16)}
    assert rt.providers[0].zero_filled == 0 and rt.providers[0].blocks
    assert rt.blocks == N_BLOCKS


def test_runtimes_decode_the_same_rciq_stream(tmp_path):
    """A usrp source over rciq (cs16; float32 blocks under ``ingest_bf16``,
    which is lossless only for 8-bit formats): the same control messages
    from both runtimes, grant included. Each runtime has a driver host of
    its own, which streams the capture from its start."""
    wide = streams.live_control("C4FM", group=901, source=46)
    runs, tuned = {}, {}
    for which, (_m, rx) in RUNTIMES.items():
        srv = Q.RcIqServer(SAMP, CENTER, fmt="cs16")

        def fill(live, need):
            assert _wait(lambda: srv.clients == 1)
            _feed(srv, wide, [live[0].ring], need)
        try:
            runs[which] = _decode(which, _config(
                rx, tmp_path / which, "usrp", f"rciq={srv.host}:{srv.port}"),
                fill)
        finally:
            srv.close()
        tuned[which] = any(c.get("cmd") == "tune" and c.get("hz") == CENTER
                           for c in srv.commands)
    (got, rt, live), (want, _, _) = runs["torch"], runs["jax"]
    assert tuned == {"jax": True, "torch": True}
    assert _grants(got, 901), f"{len(got)} control messages"
    assert got == want
    assert {g["in_dtype"] for g in rt.groups.values()} == \
        {np.dtype(np.float32)}
    assert rt.providers[0].zero_filled == 0


def test_mixed_group_stacks_bf16_bits_as_jax(tmp_path, monkeypatch):
    """One rtlsdr source (bf16 bits) and one usrp source (float32) at one
    rate share the groups; the port stacks them to float32 whose values
    equal JAX's ``ml_dtypes`` conversion of the same bf16 block, bit for
    bit (never the bit patterns read as the integers 0…65535)."""
    wide = streams.live_control("C4FM")
    rtl = R.FakeRtlTcpServer(wide, samp_rate=FAST * SAMP, realtime=True)
    usrp = Q.RcIqServer(SAMP, CENTER + SAMP, fmt="cs16")
    cfg = _config(TRX, tmp_path, "rtlsdr", f"rtl_tcp={rtl.host}:{rtl.port}")
    cfg.sources[1] = TRX.SourceConfig(
        type="usrp", args=f"rciq={usrp.host}:{usrp.port}",
        center_freq=CENTER + SAMP, samp_rate=SAMP)
    providers, live = TRT.providers_from_config(cfg)
    pulled, uploads = {}, []

    def keep(idx, prov):
        def pull(n):
            pulled[idx] = prov(n)
            return pulled[idx]
        return pull
    real_upload = TRT.wire_from_numpy

    def upload(a, device):
        uploads.append(a.copy())
        return real_upload(a, device)
    monkeypatch.setattr(TRT, "wire_from_numpy", upload)
    try:
        rt = TRT.SiteRuntime(cfg, {i: keep(i, p)
                                   for i, p in providers.items()}, "cpu")
        n = rt.block_len(0)
        assert _wait(lambda: usrp.clients == 1)
        _feed(usrp, wide, [live[1].ring], n)
        assert _wait(lambda: live[0].ring.available >= n)
        rt.step()
        rt.close()
    finally:
        for s in live:
            s.stop()
        rtl.close()
        usrp.close()
    bits, f32 = pulled[0], pulled[1]
    assert bits.dtype == np.uint16 and f32.dtype == np.float32
    assert bits.any() and f32.any()
    want = np.stack([bits.view(ml_dtypes.bfloat16).astype(np.float32), f32])
    assert {g["in_dtype"] for g in rt.groups.values()} == \
        {np.dtype(np.float32)}
    assert uploads and all(u.dtype == np.float32 for u in uploads)
    for u in uploads:
        np.testing.assert_array_equal(u.view(np.uint32),
                                      want.view(np.uint32))
