"""Build and load the CUDA kernels of ``csrc/``.

At first use ``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (one
process per source, all started together) and links them into one
shared library with a plain C interface under ``_build/`` (a directory
git ignores), named by a hash of the sources and flags so an edited
source rebuilds and an unchanged one loads at once. The library is bound
with ``ctypes``; each C entry point launches on the stream it is given
and returns ``cudaGetLastError()``. The main path's wrappers launch
through ``launch``: the span ``kernel.<name>`` and the counter
``launch.<name>`` (``utils/trace.py``).

No ``--use_fast_math``: the tracker is a feedback loop, and its atan2,
tanh, division and sin/cos must stay IEEE-accurate to track the plain
version.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

from radiocapture_tpu_torch.utils import trace

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-lineinfo")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # zb, gk, phase0, step, y_re, y_im, S, N, P, W, C, rows, z_stride,
    # stream
    "xlat_bank_launch": (_P,) * 6 + (_I,) * 6 + (ctypes.c_longlong, _P),
    # y_re, y_im, prev, sym_hist, clock, ff, hist, syms, valid, dibits,
    # consts, S, N, C, ntaps, sym_decim, gain, step, lo, spacing,
    # nlevels, k_ff, k_t, stream
    "fsk_track_launch": (_P,) * 11 + (_I,) * 5 + (_F,) * 4 + (_I, _F, _F,
                                                                _P),
    # x, clock, ff, hist, syms, valid, dibits, consts, S, M, C, step, lo,
    # spacing, nlevels, k_ff, k_t, stream
    "fsk_track_stream_launch": (_P,) * 8 + (_I,) * 3 + (_F,) * 3 + (
        _I, _F, _F, _P),
    # xn, steps, syms, valid, dibits, state_out, cycles, consts, step, lo,
    # spacing, nlevels, k_ff, k_t, stream
    "fsk_chain_probe_launch": (_P, _I) + (_P,) * 6 + (_F,) * 3 + (_I, _F,
                                                                   _F, _P),
    # x, hist, g, phase0, step, y, S, T, N, K, D, C, x_bf16, stream
    "xlat_complex_launch": (_P,) * 6 + (_I,) * 7 + (_P,),
    # y_re, y_im, scale, t, omega, freq, phase, hist_re, hist_im, prev_re,
    # prev_im, syms, valid, dibits, consts, S, N, C, n0_first, n0_count,
    # omega_lo, omega_hi, fmax, k_mu, k_om, k_f, stream
    "cqpsk_track_launch": (_P,) * 15 + (_I,) * 5 + (_F,) * 6 + (_P,),
    # x_re, x_im, t, omega, freq, phase, hist_re, hist_im, prev_re,
    # prev_im, cycles, consts, steps, n0_first, n0_count, omega_lo,
    # omega_hi, fmax, k_mu, k_om, k_f, stream
    "cqpsk_chain_probe_launch": (_P,) * 12 + (_I,) * 3 + (_F,) * 6 + (_P,),
    # y_re, y_im, prev, y_last, x_last, audio, power, S, N, C, gain, z1,
    # b0, chunk, warps, stream
    "fm_voice_launch": (_P,) * 7 + (_I,) * 3 + (_F,) * 3 + (_I, _I, _P),
    # hist, x, offs, taps, z2, g2, step, S, T, C, P, D, W, x_bf16, parts,
    # stream
    "bank_operands_launch": (_P,) * 7 + (_I,) * 8 + (_P,),
    # y_re, y_im, scale, S, N, C, stream
    "agc_launch": (_P,) * 3 + (_I,) * 3 + (_P,),
    # hist, x, hp2, v, new_hist, S, T, M, P, x_bf16, stream
    "pfb_rows_launch": (_P,) * 5 + (_I,) * 5 + (_P,),
    # hist, x, hp2, table, bins, new_hist, S, T, M, P, x_bf16, k, wb,
    # slabs, m1, m2, stream
    "pfb_bins_launch": (_P,) * 6 + (_I,) * 10 + (_P,),
    # x, xrow, hist, taps, fine, phase0, step, y_re, y_im, S, T, N, K, C,
    # rb, stream
    "pfb_fine_launch": (_P,) * 9 + (_I,) * 6 + (_P,),
}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librc_kernels_{h.hexdigest()[:16]}.so"


def _check_nvcc(cmd: list, rc: int, text: str, verbose: bool) -> None:
    if rc != 0:
        raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{text}")
    if verbose:
        print(text)


def build(verbose: bool = False) -> Path:
    """Compile the kernels if no library for these sources exists yet;
    returns its path. ``verbose`` adds ``-Xptxas -v`` and prints the
    compiler's register/shared-memory report."""
    out = library_path()
    if out.exists() and not verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    extra = ["-Xptxas", "-v"] if verbose else []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in sources()]
        compiles = [[nvcc, *NVCC_FLAGS, *extra, "-c", "-o", obj, str(src)]
                    for obj, src in zip(objs, sources())]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in compiles]
        outs = [p.communicate()[0] for p in procs]   # wait for them all
        for cmd, p, text in zip(compiles, procs, outs):
            _check_nvcc(cmd, p.returncode, text, verbose)
        lib = os.path.join(tmp, "lib.so")
        link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", lib, *objs]
        res = subprocess.run(link, capture_output=True, text=True)
        _check_nvcc(link, res.returncode, res.stdout + res.stderr, verbose)
        os.replace(lib, out)
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """The built kernel library (built on first call, once per process).
    The load's host seconds, the build's left out, count in
    ``setup.kernels_s``."""
    path = build()
    with trace.timed("setup.kernels_s"):
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.rc_error_string.argtypes = [ctypes.c_int]
        lib.rc_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise when a launch entry point returned a CUDA error."""
    if err:
        msg = load().rc_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def launch(name: str, *args) -> None:
    """Launch the kernel ``name`` through its C entry point
    ``<name>_launch`` with ``args``, inside the span ``kernel.<name>``;
    raise on a CUDA error (``check``), else count ``launch.<name>``."""
    with trace.span(f"kernel.{name}", cuda=True):
        err = getattr(load(), f"{name}_launch")(*args)
    check(err, name)
    trace.count(f"launch.{name}")
