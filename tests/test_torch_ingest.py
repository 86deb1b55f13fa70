"""Port parity, the native ingest ring: the port's ``IngestRing`` (its
own build of ``native/ingest`` under ``radiocapture_tpu_torch/_build/``)
against the JAX package's on the same pushes, for every wire format —
float32 pops equal, bf16 pops the same bits (uint16 in the port,
``ml_dtypes`` bfloat16 in JAX), zero fill, overflow accounting, wrap
continuity, the UDP feed — and the runtime's ``PacedProvider`` on a ring
fed at the stream's rate."""

import os
import shutil
import socket
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from radiocapture_tpu.frontend import ingest as J
from radiocapture_tpu_torch import runtime as TRT
from radiocapture_tpu_torch.frontend import ingest as T

RNG = np.random.default_rng(13)
PUSHES = {
    "cs16": RNG.integers(-32768, 32768, 4096).astype(np.int16),
    "cu8": RNG.integers(0, 256, 4096).astype(np.uint8),
    "cs8": RNG.integers(-128, 128, 4096).astype(np.int8),
    "cf32": (RNG.standard_normal(4096).astype(np.float32)
             * 0.3).view(np.complex64),
}
# A deadline on every wait for another thread or a socket: a stuck peer
# fails the test instead of hanging the suite.
WAIT_S = 5.0


def place_jax_ring_library():
    """Put the JAX package's ring library in place whole before a test
    loads it: a copy of the port's build of the same source with the same
    flags, moved in under a temporary name. The JAX package compiles it
    in place (``g++ -o native/build/librcingest.so``), so a JAX test file
    building it in another worker could otherwise hand this one a
    half-written library, or this one hand it one. Where the JAX
    package's library is already newer than its source, nothing is
    done."""
    src = os.path.join(J._NATIVE_DIR, "ingest", "ingest.cc")
    if os.path.exists(J._LIB_PATH) and \
            os.path.getmtime(J._LIB_PATH) >= os.path.getmtime(src):
        return
    os.makedirs(os.path.dirname(J._LIB_PATH), exist_ok=True)
    tmp = f"{J._LIB_PATH}.{os.getpid()}.tmp"
    shutil.copyfile(T.build_library(), tmp)
    os.replace(tmp, J._LIB_PATH)


@pytest.fixture(autouse=True, scope="module")
def _jax_ring_library():
    place_jax_ring_library()


def _rings(fmt, capacity=1 << 12):
    return J.IngestRing(fmt, capacity_samples=capacity), \
        T.IngestRing(fmt, capacity_samples=capacity)


def _wait(cond, timeout=WAIT_S):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return False


def test_port_builds_its_own_library():
    """The port's ring loads a library under its ``_build/``, not the
    JAX package's ``native/build/``."""
    path = T.build_library()
    assert "radiocapture_tpu_torch/_build/native/" in path
    assert path != J.build_library()


@pytest.mark.parametrize("fmt", sorted(PUSHES))
def test_pop_equals_jax(fmt):
    """The same pushes, popped as float32 in uneven pieces, give equal
    arrays; the ring then reports the same emptiness."""
    jr, tr = _rings(fmt)
    data = PUSHES[fmt]
    for a, b in ((0, 1000), (1000, 3000), (3000, len(data))):
        assert jr.push(data[a:b]) == tr.push(data[a:b])
    assert jr.available == tr.available
    for n in (7, 300, 1):
        np.testing.assert_array_equal(tr.pop(n), jr.pop(n))
    n = tr.available
    np.testing.assert_array_equal(tr.pop(n), jr.pop(n))
    assert tr.pop(1) is None and jr.pop(1) is None
    jr.close()
    tr.close()


@pytest.mark.parametrize("fmt", sorted(PUSHES))
def test_pop_bf16_bits_equal_jax(fmt):
    """``pop_bf16`` hands the bit patterns of JAX's bfloat16 pop as
    uint16, [n, 2]; the exact float32 of those bits is JAX's
    ``astype(float32)``."""
    jr, tr = _rings(fmt)
    jr.push(PUSHES[fmt])
    tr.push(PUSHES[fmt])
    n = tr.available
    got, want = tr.pop_bf16(n), jr.pop_bf16(n)
    assert got.dtype == np.uint16 and got.shape == (n, 2)
    np.testing.assert_array_equal(got, want.view(np.uint16))
    np.testing.assert_array_equal(
        (got.astype(np.uint32) << 16).view(np.float32),
        want.astype(np.float32))
    assert tr.pop_bf16(1) is None
    jr.close()
    tr.close()


@pytest.mark.parametrize("bf16", [False, True])
def test_provider_zero_fill_as_jax(bf16):
    """A non-strict provider zero-fills an under-filled ring (uint16
    zeros, the bits of bf16 zeros, where JAX gives ``ml_dtypes`` zeros),
    a strict one returns None, and a full block equals JAX's."""
    jr, tr = _rings("cs8")
    jp, tp = jr.provider(strict=False, bf16=bf16), \
        tr.provider(strict=False, bf16=bf16)
    got, want = tp(32), jp(32)
    assert got.shape == (32, 2) and not got.any()
    assert got.dtype == (np.uint16 if bf16 else np.float32)
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
    assert tr.provider(strict=True, bf16=bf16)(32) is None
    for r in (jr, tr):
        r.push(PUSHES["cs8"][:64])
    got, want = tp(32), jp(32)
    assert got.any()
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
    jr.close()
    tr.close()


def test_overflow_accounting_as_jax():
    """Overfilled rings accept and drop the same counts, and keep the
    same (oldest) samples, on a single push and under sustained overflow
    with random pops."""
    jr, tr = _rings("cs8", capacity=16)
    data = np.arange(-100, 100, dtype=np.int8)
    assert tr.push(data) == jr.push(data) == 16
    assert tr.dropped == jr.dropped == 100 - 16
    np.testing.assert_array_equal(tr.pop(16), jr.pop(16))
    jr.close()
    tr.close()

    jr, tr = _rings("cs16", capacity=64)
    seq = np.arange(0, 8192, dtype=np.int16)
    rng = np.random.default_rng(7)
    pos, got = 0, []
    while pos < len(seq):
        chunk = seq[pos:pos + 2 * int(rng.integers(8, 90))]
        pos += len(chunk)
        assert tr.push(chunk) == jr.push(chunk)
        assert tr.available == jr.available and 0 <= tr.available <= 64
        if rng.random() < 0.7:
            take = min(tr.available, int(rng.integers(1, 40)))
            if take:
                out = tr.pop(take)
                np.testing.assert_array_equal(out, jr.pop(take))
                got.append(out)
    got = (np.concatenate(got).ravel() * 32768.0).astype(np.int64)
    assert np.all(np.diff(got) > 0)           # never replayed or reordered
    assert tr.dropped == jr.dropped
    assert tr.dropped + tr.available + len(got) // 2 == len(seq) // 2
    jr.close()
    tr.close()


def test_wrap_continuity_as_jax():
    """Pushes and pops across the ring's wrap deliver the whole stream,
    as JAX's ring does."""
    jr, tr = _rings("cs16", capacity=64)
    seq = np.arange(0, 4096, dtype=np.int16)
    out = []
    for pos in range(0, len(seq), 48):
        chunk = seq[pos:pos + 48]
        jr.push(chunk)
        tr.push(chunk)
        blk = tr.pop(len(chunk) // 2)
        np.testing.assert_array_equal(blk, jr.pop(len(chunk) // 2))
        out.append(blk)
    np.testing.assert_array_equal(
        (np.concatenate(out).ravel() * 32768.0).astype(np.int16), seq)
    jr.close()
    tr.close()


def _free_udp_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_udp_feed_to_provider():
    """Datagrams reach the ring through the port's ``UdpFeed`` and come
    out of its provider as JAX's ring converts the same samples."""
    r = T.IngestRing("cs16", capacity_samples=1 << 16)
    port = _free_udp_port()
    feed = T.UdpFeed(r, port=port, bind_addr="127.0.0.1")
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    payload = np.arange(1024, dtype=np.int16)
    try:
        for _ in range(4):
            tx.sendto(payload.tobytes(), ("127.0.0.1", port))
        assert _wait(lambda: r.available >= 2048)
        blk = r.provider(strict=False)(512)
        ref = J.IngestRing("cs16", capacity_samples=1 << 12)
        ref.push(payload)
        assert blk.shape == (512, 2) and blk.dtype == np.float32
        np.testing.assert_array_equal(blk, ref.pop(512))
        ref.close()
    finally:
        feed.stop()
        tx.close()
        r.close()


# ----------------------------------------------- the paced provider
PACE_RATE = 240_000.0       # samples/s
PACE_BLOCK = 96_000         # 400 ms: 200 ms of grace for a late producer
PACE_CHUNK = 2_400          # the producer's push, 10 ms
PACE_RUN_S = 2.4
PACE_LEAD = 2               # blocks in the ring before the consumer starts
PACE_LATE_S = 0.25          # sleep overshoot allowed past a block's wait
PACE_EARLY_S = 0.05         # the loop's own time between two calls


def test_paced_provider_waits_for_the_stream():
    """A producer pushes at the stream's rate for 2.4 s while a tight loop
    pulls blocks through ``PacedProvider``: no block is zero-filled while
    it runs, and the loop is held to the stream (no more blocks than were
    pushed). Once the producer stops and the ring drains, the first
    missing block is zero-filled half a block past its due time (a block
    and a half after the last block was in the ring), and each later one
    a block after the one before."""
    ring = T.IngestRing("cs16", capacity_samples=1 << 20)
    src = SimpleNamespace(ring=ring, samp_rate=PACE_RATE)
    paced = TRT.PacedProvider(src, ring.provider(strict=False))
    chunk = (np.arange(2 * PACE_CHUNK) % 2000 - 1000).astype(np.int16)
    running = threading.Event()
    running.set()
    pushed = [0]

    def produce():
        t0 = time.perf_counter()
        k = 0
        while running.is_set():
            ring.push(chunk)
            pushed[0] += PACE_CHUNK
            k += 1
            time.sleep(max(0.0, t0 + k * PACE_CHUNK / PACE_RATE
                           - time.perf_counter()))

    producer = threading.Thread(target=produce, daemon=True)
    producer.start()
    try:
        assert _wait(lambda: ring.available >= PACE_LEAD * PACE_BLOCK)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < PACE_RUN_S:
            blk = paced(PACE_BLOCK)
            assert blk.shape == (PACE_BLOCK, 2) and blk.any()
        assert paced.zero_filled == 0
        assert paced.blocks * PACE_BLOCK <= pushed[0]
        assert paced.blocks >= PACE_RUN_S * PACE_RATE / PACE_BLOCK - 2
    finally:
        running.clear()
        producer.join(WAIT_S)
    assert not producer.is_alive()
    while ring.available >= PACE_BLOCK:      # what was pushed comes out
        assert paced(PACE_BLOCK).any()
    assert paced.zero_filled == 0
    block = PACE_BLOCK / PACE_RATE
    for k, due in ((1, 1.5 * block), (2, block), (3, block)):
        blk = paced(PACE_BLOCK)
        assert not blk.any() and paced.zero_filled == k
        assert due - PACE_EARLY_S <= paced.last_wait_s < due + PACE_LATE_S
    ring.close()
