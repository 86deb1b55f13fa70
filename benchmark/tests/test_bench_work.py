"""The work counts of ``work/`` against counts made by hand at one small
shape."""

from benchmark.core import spec

CELL = spec.Cell(spec.manifest(), "p25_c4fm.rtl_2m4")

# 2 sources of 960 bf16 samples, 4 slots, a 192-tap bank decimating by
# 96 (10 outputs), boxcar of 3 taps, tracking at half rate
SH = {"sources": 2, "block": 960, "slots": 4, "lanes": 8, "wire_bytes": 2,
      "taps": 192, "decim": 96, "n_out": 10, "sym_taps": 3, "sym_decim": 2,
      "split_taps": 20, "half": 480, "branches": 4, "branch_taps": 3,
      "fine_taps": 7, "fine_decim": 2, "bin_rows": 240}


def test_xlat_bank():
    w = CELL.work_module("xlat_bank").count(SH)
    # 2·4·10 outputs × 192 complex taps × 8 FLOP
    assert w["flop"] == {"bfloat16": 122880.0}
    # wire 2·960·4 B, history 2·191·4 B in and out, phases 2·4·4 B in and
    # out, taps 192·4 B, planes 2·10·4·8 B
    assert w["bytes"] == 7680 + 3056 + 64 + 768 + 640


def test_split2_bank():
    sh = dict(SH, lanes=16, n_out=5)
    w = CELL.work_module("split2_bank").count(sh)
    # split: 2 sources × 2 halves × 480 outputs × 20 taps × 8; bank: 4
    # halves × 4 slots × 5 outputs × 192 taps × 8
    assert w["flop"] == {"float32": 307200.0, "bfloat16": 122880.0}
    # wire 7680, split history 2·19·4 in and out (304), bank history
    # 4·191·8 in and out (12224), phases (2·2 + 4·4)·4 in and out (160),
    # taps 212·4 (848), planes 4·5·4·8 (640)
    assert w["bytes"] == 7680 + 304 + 12224 + 160 + 848 + 640


def test_pfb_bank():
    w = CELL.work_module("pfb_bank").count(dict(SH, n_out=120))
    # coarse 4·3·2·960 + 5·2·960·log2 4 + 6·2·960; fine 2·4·120·7·8
    assert w["flop"] == {"float32": 23040.0 + 19200.0 + 11520.0 + 53760.0}
    # wire 7680, coarse history 2·2·8·4 (128), fine history 2·2·4·6·8
    # (768), phases 64, taps (12 + 7)·4 (76), planes 2·120·4·8 (7680)
    assert w["bytes"] == 7680 + 128 + 768 + 64 + 76 + 7680


def test_trackers():
    fsk = CELL.work_module("fsk_track").count(SH)
    # 8 lanes: planes 10·8 B, 5 tracked samples × 3 outputs × 4 B, state
    # (8 + 2·4 + 4 + 4 + 32) B in and out
    assert fsk == {"flop": {}, "bytes": 8 * (80 + 60 + 112)}
    cq = CELL.work_module("cqpsk_track").count(SH)
    # 10 samples: planes 80 B, outputs 120 B, state 54 floats in and out
    assert cq == {"flop": {}, "bytes": 8 * (80 + 120 + 432)}
