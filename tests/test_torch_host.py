"""Port parity, host decode: the port's framer, control engines, protocol
parsers and FEC are copies of the JAX package's numpy-only modules, made
so the port imports nothing of ``radiocapture_tpu``. Each copy must equal
its original with the package name changed; the decode tests of
``test_torch_fsk4.py`` and ``test_torch_pipeline.py`` run the copies."""

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
          "protocol/p25", "protocol/p25_fields"]


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
