"""Device and wire-format helpers.

The ingest wire layout is ``[S, T, 2]`` re/im pairs, bfloat16 by default
(lossless for the 8-bit RTL-class SDR formats, half the float32 stream).
numpy has no bfloat16: the port's ingest ring hands bf16 blocks as their
uint16 bit patterns, and an ``ml_dtypes`` bf16 array (which
``torch.from_numpy`` rejects) is moved through the same bits, so this
package never imports ``ml_dtypes``.
"""

from __future__ import annotations

import numpy as np
import torch


def require_cuda() -> torch.device:
    """The first CUDA device; raises when PyTorch sees none."""
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA device is required: "
                           "torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


def resolve(device) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` is :func:`require_cuda`,
    the default of every entry point that touches the device."""
    return require_cuda() if device is None else torch.device(device)


def wire_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """``[..., 2]`` re/im numpy block → tensor on ``device``: float32
    stays float32; uint16 (bf16 bit patterns, as the ingest ring pops
    them) and ``ml_dtypes`` bfloat16 become ``torch.bfloat16``."""
    if a.dtype == np.uint16 or a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)


def complex_to_wire(x: np.ndarray, device,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Complex numpy IQ ``[..., T]`` → ``[..., T, 2]`` wire block of
    ``dtype`` on ``device``, rounded on the host so only ``dtype`` bytes
    cross to the device."""
    x = torch.from_numpy(np.ascontiguousarray(x, np.complex64))
    return torch.view_as_real(x).to(dtype).to(device)
