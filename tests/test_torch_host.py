"""Port parity, host code: the port's framer, control engines, protocol
parsers, FEC, control plane, audio sinks, scheduler, config schema and
the stdlib/numpy tools (uploader, audio GC, drift measurement), the
live-SDR clients and servers (rtl_tcp, rciq), the frontend control
server, device discovery and the supervisor are copies of the JAX
package's host modules, made so the port imports nothing of
``radiocapture_tpu``. Each copy must equal its original with the package
name changed; the recorder everywhere but ``_to_8k``, the ingest ring
everywhere but its build directory and bf16 consumer, the soak on every
line but those naming its device;
the decode and runtime tests of ``tests/test_torch_*.py`` run the
copies."""

import os

import numpy as np
import pytest

from radiocapture_tpu.fec import bits as JB
from radiocapture_tpu.protocol import p25 as JP
from radiocapture_tpu_torch.demod.framer import Framer
from radiocapture_tpu_torch.fec import bits as TB
from radiocapture_tpu_torch.protocol import p25 as TP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPIES = ["demod/engines", "demod/framer", "demod/tdma", "fec/bits",
          "fec/crc", "fec/golay", "fec/hamming", "fec/linear", "fec/lfsr",
          "fec/rs6", "fec/trellis", "protocol/edacs", "protocol/moto",
          "protocol/p25", "protocol/p25_fields", "audio/wav",
          "audio/postproc", "audio/imbe", "demod/provoice", "control/bus",
          "control/resp", "control/stomp", "control/presence",
          "control/call_manager", "control/metadata_agent",
          "control/recorder_manager", "frontend/scheduler",
          "rxconfig/__init__", "utils/logconfig", "tools/uploader",
          "tools/audio_gc", "tools/measure_drift", "frontend/rtl_tcp",
          "frontend/rciq", "frontend/server", "frontend/device_discovery",
          "control/overseer"]


def _source(package, module):
    with open(os.path.join(REPO, package, module + ".py")) as f:
        return f.read()


@pytest.mark.parametrize("module", COPIES)
def test_host_module_is_a_copy(module):
    want = _source("radiocapture_tpu", module).replace(
        "radiocapture_tpu.", "radiocapture_tpu_torch.")
    got = _source("radiocapture_tpu_torch", module)
    assert got == want
    assert "radiocapture_tpu." not in got


def _without_to_8k(src):
    start = src.index("    def _to_8k(")
    return src[:start] + src[src.index("    # ---- P25 digital path", start):]


def test_recorder_is_a_copy_but_to_8k():
    """``audio/recorder.py`` equals its original everywhere but
    ``CallRecorder._to_8k``, which resamples with the port's torch
    resampler instead of ``jax.numpy``."""
    want = _source("radiocapture_tpu", "audio/recorder").replace(
        "radiocapture_tpu.", "radiocapture_tpu_torch.")
    got = _source("radiocapture_tpu_torch", "audio/recorder")
    assert _without_to_8k(got) == _without_to_8k(want)
    assert "jax" not in got and "radiocapture_tpu." not in got


def _cut(src, start, end):
    """``src`` without the text from ``start`` up to (not including)
    ``end``."""
    i = src.index(start)
    return src[:i] + src[src.index(end, i):]


def _ported(module):
    want = _source("radiocapture_tpu", module).replace(
        "radiocapture_tpu.", "radiocapture_tpu_torch.")
    return _source("radiocapture_tpu_torch", module), want


# The parts of ``frontend/ingest.py`` where the port differs: where the
# library is built, and the bf16 pop and zero block as uint16 bits.
INGEST_PARTS = [("_LIB_PATH = ", "_lock = "),
                ("def build_library(", "def _load():"),
                ("    def pop_bf16(", "    @property"),
                ("        if bf16:\n", "        def pull(n: int):")]


def test_ingest_is_a_copy_but_bf16_bits_and_build_dir():
    """``frontend/ingest.py`` equals its original but for ``_LIB_PATH`` and
    ``build_library`` (the port's ``_build/native/``, written under a
    temporary name and moved into place) and the bf16 consumer (uint16
    bits, no ``ml_dtypes``): ``pop_bf16`` and the bf16 provider."""
    got, want = _ported("frontend/ingest")
    for start, end in INGEST_PARTS:
        got, want = _cut(got, start, end), _cut(want, start, end)
    assert got == want
    full = _source("radiocapture_tpu_torch", "frontend/ingest")
    assert "ml_dtypes" not in full and "radiocapture_tpu." not in full
    assert '"_build",' in full and "os.replace(" in full
    assert "np.zeros((n, 2), np.uint16)" in full


# How the port's soak passes its device on: each edit, and what it stands
# for in the original line.
SOAK_EDITS = ((", device=None", ""), ("resolve_device(device), ", ""),
              (", device)", ")"))


def test_soak_is_a_copy_but_device():
    """``tools/soak.py`` equals its original but where it takes the
    runtimes' device: ``_SoakSite`` and ``run_soak`` take ``device``,
    ``run_soak`` resolves it before starting anything, and ``_SoakSite``
    hands it to the port's ``SiteRuntime``. Undo those edits, drop the
    lines they added (each names the device), and the original is
    left."""
    got, want = _ported("tools/soak")
    lines = []
    for ln in got.splitlines():
        for edit, orig in SOAK_EDITS:
            ln = ln.replace(edit, orig)
        if "device" not in ln:
            lines.append(ln)
    assert lines == want.splitlines()
    assert "device" not in want
    assert "resolve_device(device), bus=self.bus)" in got
    assert "jax" not in got and "radiocapture_tpu." not in got


def test_host_copy_round_trips_a_tsdu():
    """A TSDU packed by the JAX package decodes through the port's framer
    and parser to the same TSBKs."""
    t1 = JP.pack_tsbk("GRP_V_CH_GRANT", mfid=0, **{
        "Service Options": 0, "Channel": 0x1001, "Group Address": 101,
        "Source Address": 555001})
    bits = np.concatenate([JP.build_tsdu_frame(0x293, [t1])] * 3)
    dibits = JB.bits_to_dibits(bits)
    np.testing.assert_array_equal(TB.bits_to_dibits(bits), dibits)
    frames = Framer().feed(np.asarray(dibits, np.uint8))
    assert len(frames) >= 2
    for fb in frames:
        got, want = TP.parse_frame(fb), JP.parse_frame(fb)
        assert got.tsbks == want.tsbks
        assert got.tsbks[0]["Channel"] == 0x1001
