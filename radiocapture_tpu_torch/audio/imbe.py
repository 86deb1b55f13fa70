"""ctypes binding to the native C++ vocoder (native/imbe).

Fills the op25 ``repeater.vocoder`` slot (reference
logging_receiver.py:253, file_to_wav.py:92) as a host library — voice
decode is per-call 8 kHz work, not a TPU kernel (SURVEY.md §7 hard part
4). The library is built on demand with g++ the first time it is needed
(cached under ``native/build/``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from radiocapture_tpu_torch.audio.recorder import Vocoder

_REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", ".."))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "build", "libimbe.so")
_lock = threading.Lock()
_lib = None


class _Params(ctypes.Structure):
    _fields_ = [("b0", ctypes.c_int),
                ("voicing", ctypes.c_uint32),
                ("gain", ctypes.c_int),
                ("amps", ctypes.c_uint8 * 56)]


def build_library(force: bool = False) -> str:
    """Compile native/imbe into libimbe.so (idempotent)."""
    src = os.path.join(_NATIVE_DIR, "imbe", "imbe.cc")
    newest = max(os.path.getmtime(os.path.join(_NATIVE_DIR, "imbe", f))
                 for f in ("imbe.cc", "imbe.h", "imbe_tables.h"))
    if force or not os.path.exists(_LIB_PATH) or \
            os.path.getmtime(_LIB_PATH) < newest:
        os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
        subprocess.run(
            ["g++", "-O2", "-fPIC", "-shared", "-o", _LIB_PATH, src,
             "-lm"],
            check=True, cwd=_NATIVE_DIR, capture_output=True)
    return _LIB_PATH


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build_library())
        lib.imbe_decoder_create.restype = ctypes.c_void_p
        lib.imbe_decoder_destroy.argtypes = [ctypes.c_void_p]
        lib.imbe_decode.restype = ctypes.c_int
        lib.imbe_decode.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_uint8),
                                    ctypes.POINTER(ctypes.c_int16)]
        lib.imbe_errors.restype = ctypes.c_int
        lib.imbe_errors.argtypes = [ctypes.c_void_p]
        lib.imbe_encoder_create.restype = ctypes.c_void_p
        lib.imbe_encoder_destroy.argtypes = [ctypes.c_void_p]
        lib.imbe_encode.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_int16),
                                    ctypes.POINTER(ctypes.c_uint8)]
        lib.imbe_encode_params.argtypes = [ctypes.POINTER(_Params),
                                           ctypes.POINTER(ctypes.c_uint8)]
        lib.imbe_unpack_frame.restype = ctypes.c_int
        lib.imbe_unpack_frame.argtypes = [ctypes.POINTER(ctypes.c_uint8),
                                          ctypes.POINTER(_Params)]
        lib.imbe_golay23_encode.restype = ctypes.c_uint32
        lib.imbe_golay23_encode.argtypes = [ctypes.c_uint32]
        lib.imbe_golay23_decode.restype = ctypes.c_int
        lib.imbe_golay23_decode.argtypes = [ctypes.c_uint32,
                                            ctypes.POINTER(ctypes.c_uint32)]
        lib.imbe_harmonics_for_b0.restype = ctypes.c_int
        lib.imbe_harmonics_for_b0.argtypes = [ctypes.c_int]
        lib.imbe_bands_for_L.restype = ctypes.c_int
        lib.imbe_bands_for_L.argtypes = [ctypes.c_int]
        lib.imbe_coef_alloc.restype = ctypes.c_int
        lib.imbe_coef_alloc.argtypes = [ctypes.c_int, ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_int)]
        lib.imbe_scan_params.argtypes = [ctypes.POINTER(_Params),
                                         ctypes.POINTER(ctypes.c_uint8)]
        _lib = lib
        return _lib


class ImbeVocoder(Vocoder):
    """decode(144 bits) -> 160 int16 PCM @8 kHz."""

    def __init__(self):
        self._lib = _load()
        self._dec = self._lib.imbe_decoder_create()
        self.available = True

    def __del__(self):
        try:
            if getattr(self, "_dec", None):
                self._lib.imbe_decoder_destroy(self._dec)
        except Exception:
            pass

    def decode(self, codeword144: np.ndarray) -> np.ndarray:
        bits = np.ascontiguousarray(np.asarray(codeword144, np.uint8) & 1)
        if bits.size != 144:
            raise ValueError("IMBE codeword must be 144 bits")
        pcm = np.zeros(160, np.int16)
        self._lib.imbe_decode(
            self._dec,
            bits.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)))
        return pcm

    @property
    def errors(self) -> int:
        return int(self._lib.imbe_errors(self._dec))


class ImbeEncoder:
    """Analysis side — fixture generation + closed-loop tests."""

    def __init__(self):
        self._lib = _load()
        self._enc = self._lib.imbe_encoder_create()

    def __del__(self):
        try:
            if getattr(self, "_enc", None):
                self._lib.imbe_encoder_destroy(self._enc)
        except Exception:
            pass

    def encode(self, pcm160: np.ndarray) -> np.ndarray:
        pcm = np.ascontiguousarray(np.asarray(pcm160, np.int16))
        if pcm.size != 160:
            raise ValueError("IMBE frame is 160 samples")
        bits = np.zeros(144, np.uint8)
        self._lib.imbe_encode(
            self._enc,
            pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            bits.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return bits

    def encode_params(self, b0: int, voicing: int, gain: int,
                      amps=None) -> np.ndarray:
        p = _Params()
        p.b0, p.voicing, p.gain = b0, voicing, gain
        for i, a in enumerate(amps or []):
            p.amps[i] = a
        bits = np.zeros(144, np.uint8)
        self._lib.imbe_encode_params(
            ctypes.byref(p),
            bits.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return bits


def unpack_frame(bits144: np.ndarray) -> tuple[dict, int]:
    """(params, corrected_errors); errors -1 → unusable frame."""
    lib = _load()
    bits = np.ascontiguousarray(np.asarray(bits144, np.uint8) & 1)
    p = _Params()
    errs = lib.imbe_unpack_frame(
        bits.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.byref(p))
    return ({"b0": p.b0, "voicing": p.voicing, "gain": p.gain,
             "amps": list(p.amps)}, errs)


def golay23_encode(data12: int) -> int:
    return int(_load().imbe_golay23_encode(data12))


def golay23_decode(cw: int) -> tuple[int, int]:
    out = ctypes.c_uint32()
    n = _load().imbe_golay23_decode(cw, ctypes.byref(out))
    return int(out.value), int(n)


def harmonics_for_b0(b0: int) -> int:
    return int(_load().imbe_harmonics_for_b0(b0))


def bands_for_l(l: int) -> int:
    """K = min(12, (L+2)//3) voicing bands."""
    return int(_load().imbe_bands_for_L(l))


def coef_alloc(l: int, k: int) -> list[int]:
    """Per-coefficient amplitude bit allocation for an (L, K) geometry:
    N = L-1 entries in priority order (PRBA G1..G5, then higher-order
    block DCT coefficients)."""
    q = (ctypes.c_int * 55)()
    n = _load().imbe_coef_alloc(l, k, q)
    return [int(q[i]) for i in range(n)]


def scan_params(b0: int, voicing: int, gain: int, amps=None) -> np.ndarray:
    """The 88-bit priority stream (u0..u7 info bits) for a parameter
    set — exposes the bit layout for tests."""
    lib = _load()
    p = _Params()
    p.b0, p.voicing, p.gain = b0, voicing, gain
    for i, a in enumerate(amps or []):
        p.amps[i] = a
    info = np.zeros(88, np.uint8)
    lib.imbe_scan_params(ctypes.byref(p),
                         info.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return info


def install_default() -> ImbeVocoder:
    """Build/load the native vocoder and register it as the recorder
    default."""
    from radiocapture_tpu_torch.audio.recorder import set_default_vocoder
    v = ImbeVocoder()
    set_default_vocoder(v)
    return v
