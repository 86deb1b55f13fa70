"""Streaming WAV output (the reference's ``blocks.wavfile_sink`` role,
logging_receiver.py:78,583-611): 16-bit mono PCM, float [-1,1] input."""

from __future__ import annotations

import os
import wave

import numpy as np


class WavWriter:
    def __init__(self, path: str, sample_rate: int = 8000):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self.path = path
        self.sample_rate = int(sample_rate)
        self._w = wave.open(path, "wb")
        self._w.setnchannels(1)
        self._w.setsampwidth(2)
        self._w.setframerate(self.sample_rate)
        self.frames_written = 0

    def write(self, samples: np.ndarray) -> None:
        x = np.clip(np.asarray(samples, np.float32), -1.0, 1.0)
        pcm = (x * 32767.0).astype("<i2")
        self._w.writeframes(pcm.tobytes())
        self.frames_written += len(pcm)

    def write_pcm16(self, pcm: np.ndarray) -> None:
        self._w.writeframes(np.asarray(pcm, "<i2").tobytes())
        self.frames_written += len(pcm)

    @property
    def duration_s(self) -> float:
        return self.frames_written / self.sample_rate

    def close(self) -> None:
        self._w.close()


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """(float32 [-1,1] samples, sample_rate)."""
    with wave.open(path, "rb") as w:
        rate = w.getframerate()
        pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    return pcm.astype(np.float32) / 32767.0, rate
