"""GE/Ericsson ProVoice (EDACS digital voice) framing.

The reference decodes ProVoice by shelling the discriminator stream out
to the DSD C library (logging_receiver.py:334-351: quadrature_demod →
resample 48k → ``dsd.block_ff(dsd_FRAME_PROVOICE, ...)``), which does
symbol recovery, sync search, frame extraction, and IMBE 7100x4400
audio synthesis via mbelib.  Here the 9600 Bd symbol chain is the
shared EDACS-class batched pipeline (control/recorder_manager.py
``MOD_TO_STREAM``); this module is the framing layer on its bit
stream: sync detection and voice-codeword extraction, so recordings
carry *structured* ProVoice frames and counts instead of opaque bits.
IMBE 7100x4400 audio synthesis stays out of scope (the native vocoder
implements 7200x4400 for P25); extracted codewords are preserved in a
``.pv`` sidecar for offline decode.

Provenance (same discipline as the I-ISCH header, demod/tdma.py):

* PUBLIC: the four 32-symbol sync patterns (standard + EA, both
  polarities) are the published DSD constants (dsd.h PROVOICE_SYNC /
  PROVOICE_EA_SYNC / INV_*); 9600 bps binary FSK; the vocoder is IMBE
  7100x4400 with a 168-bit interleaved frame per 20 ms (mbelib's
  7x24 layout).
* RECONSTRUCTED: the inter-sync cadence.  This build assumes an 80 ms
  superframe — sync(32) + 4 x 168-bit voice codewords + 64 aux bits =
  768 bits = exactly 4 vocoder frames at 9600 bps — which is
  self-consistent (voice cadence preserved with no gaps) but NOT
  verified against an off-air capture.  The framer therefore
  **self-calibrates**: it histograms the intervals between detected
  syncs at runtime, and when a consistent cadence contradicting the
  assumed stride emerges (``CADENCE_VOTES`` agreeing intervals), it
  adapts its stride to the measured value — a wrong reconstruction
  degrades to a few sync-rate-limited superframes and then corrects
  itself.  The measured cadence is recorded in the CDR
  (``provoice_cadence_bits``) and the ``.pv`` sidecar's companion
  JSON.

In DSD's symbol alphabet the sync strings use '1' (positive outer
deviation) and '3' (negative); the EDACS pipeline slices positive
frequency to bit 1, so '1' → 1, '3' → 0 here.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

SYMBOL_RATE = 9600.0
SYNC_BITS = 32
VOICE_BITS = 168              # IMBE 7100x4400 interleaved frame (7x24)
VOICE_PER_SUPERFRAME = 4
AUX_BITS = 64
SUPERFRAME_BITS = (SYNC_BITS + VOICE_PER_SUPERFRAME * VOICE_BITS
                   + AUX_BITS)                       # 768 = 80 ms

#: published DSD sync patterns (dsd.h), as bit arrays ('1'→1, '3'→0)
_DSD_SYNCS = {
    "pv": "13131313111313311331313311311331",       # PROVOICE_SYNC
    "pv_inv": "31313131333131133113131133133113",    # INV_PROVOICE_SYNC
    "pv_ea": "31131311331331111133311311133311",     # PROVOICE_EA_SYNC
    "pv_ea_inv": "13313133113113333311133133311133",  # INV_PROVOICE_EA
}
SYNC_PATTERNS = {
    name: np.array([1 if ch == "1" else 0 for ch in s], np.uint8)
    for name, s in _DSD_SYNCS.items()
}

#: sync correlation tolerance in bit errors (32-bit patterns; the four
#: patterns are mutually distant, ≤3 keeps them unambiguous)
SYNC_TOLERANCE = 3

#: coast through this many consecutive failed superframe syncs before
#: dropping carrier lock (sync loss → search from scratch)
MAX_SYNC_COAST = 1

#: cadence self-calibration: adapt the stride once this many observed
#: inter-sync intervals agree on a value that contradicts the current
#: stride; sane range for one superframe (≥ sync + 1 codeword, ≤ 16
#: vocoder frames).
CADENCE_VOTES = 4
CADENCE_MIN = SYNC_BITS + VOICE_BITS
CADENCE_MAX = SYNC_BITS + 16 * VOICE_BITS


@dataclass
class ProVoiceFrame:
    """One superframe: 4 extracted voice codewords + metadata."""
    variant: str                  # 'pv' | 'pv_ea'
    inverted: bool                # FM sense inverted on air
    voice: list = field(default_factory=list)   # 4x [168] uint8 bits
    aux: np.ndarray | None = None               # [64] raw aux bits
    sync_errors: int = 0


def _best_sync(win32: np.ndarray) -> tuple[str, int]:
    """(pattern name, bit errors) of the closest sync pattern."""
    best, errs = "", SYNC_BITS + 1
    for name, pat in SYNC_PATTERNS.items():
        d = int((win32 != pat).sum())
        if d < errs:
            best, errs = name, d
    return best, errs


class ProVoiceFramer:
    """Streaming ProVoice sync search + codeword extraction over the
    9600 Bd sliced bit stream (low bit of the EDACS-class pipeline's
    dibit output)."""

    def __init__(self):
        self._buf = np.zeros(0, np.uint8)
        self._synced = False
        self._variant = "pv"
        self._inverted = False
        self._coast = 0
        self.sync_losses = 0
        #: current inter-sync stride (bits); starts at the reconstructed
        #: 768 and self-calibrates from observed sync intervals.
        self.stride = SUPERFRAME_BITS
        self.cadence_adapted = False
        self._abs = 0                     # absolute index of _buf[0]
        self._sync_pos: list[int] = []    # absolute detected-sync starts

    def _trim(self, n: int) -> None:
        self._buf = self._buf[n:]
        self._abs += n

    def _saw_sync(self, pos: int | None = None) -> None:
        """Record a detected sync start (absolute bit position) and
        recalibrate the stride when enough observed intervals agree on
        a different cadence (module docstring: the 768 is
        RECONSTRUCTED)."""
        pos = self._abs if pos is None else pos
        if self._sync_pos and pos <= self._sync_pos[-1]:
            return
        self._sync_pos.append(pos)
        if len(self._sync_pos) > 64:
            del self._sync_pos[0]
        d = np.diff(self._sync_pos)
        d = d[(d >= CADENCE_MIN) & (d <= CADENCE_MAX)]
        if len(d) < CADENCE_VOTES:
            return
        vals, counts = np.unique(d, return_counts=True)
        mode = int(vals[int(np.argmax(counts))])
        if int(counts.max()) < CADENCE_VOTES or mode == self.stride:
            return
        if mode % self.stride == 0:
            # an exact multiple of the current stride is what periodic
            # sync dropouts look like (every k-th sync hidden) — the
            # current stride already explains the observations, and
            # adapting up would shunt the hidden frames' codewords into
            # aux; keep the shorter hypothesis.
            return
        self.stride = mode
        self.cadence_adapted = True
        self._sync_pos = self._sync_pos[-1:]

    def feed(self, bits: np.ndarray) -> list[ProVoiceFrame]:
        self._buf = np.concatenate(
            [self._buf, np.asarray(bits, np.uint8) & 1])
        out: list[ProVoiceFrame] = []
        while True:
            if not self._synced:
                idx = self._find_sync(self._buf)
                if idx is None:
                    keep = max(0, len(self._buf) - SYNC_BITS + 1)
                    self._trim(keep)
                    return out
                self._trim(idx)
                name, _ = _best_sync(self._buf[:SYNC_BITS])
                self._variant = "pv_ea" if "ea" in name else "pv"
                self._inverted = name.endswith("_inv")
                self._synced = True
                self._coast = 0
                self._saw_sync()
            if len(self._buf) < self.stride:
                return out
            sf = self._buf[:self.stride]
            name, errs = _best_sync(sf[:SYNC_BITS])
            variant = "pv_ea" if "ea" in name else "pv"
            if errs > SYNC_TOLERANCE or variant != self._variant:
                self._coast += 1
                if self._coast > MAX_SYNC_COAST:
                    self._synced = False
                    self.sync_losses += 1
                    self._trim(1)
                    continue
            else:
                self._coast = 0
                self._inverted = name.endswith("_inv")
                self._saw_sync()
            # cadence estimator: a sync appearing INSIDE the frame
            # window means the true inter-sync interval is shorter than
            # the stride — record it so the histogram sees the real
            # cadence instead of resync multiples.
            inner = self._find_sync(sf[SYNC_BITS:])
            if inner is not None:
                self._saw_sync(self._abs + SYNC_BITS + inner)
            body = sf[SYNC_BITS:]
            if self._inverted:
                body = body ^ 1        # undo inverted FM sense
            fr = ProVoiceFrame(variant=self._variant,
                               inverted=self._inverted,
                               sync_errors=errs if errs <= SYNC_BITS
                               else 0)
            n_voice = min(VOICE_PER_SUPERFRAME,
                          (self.stride - SYNC_BITS) // VOICE_BITS)
            for j in range(n_voice):
                fr.voice.append(
                    body[j * VOICE_BITS:(j + 1) * VOICE_BITS].copy())
            fr.aux = body[n_voice * VOICE_BITS:].copy()
            out.append(fr)
            self._trim(self.stride)

    @staticmethod
    def _find_sync(buf: np.ndarray) -> int | None:
        if len(buf) < SYNC_BITS:
            return None
        win = np.lib.stride_tricks.sliding_window_view(buf, SYNC_BITS)
        for pat in SYNC_PATTERNS.values():
            dist = (win != pat[None, :]).sum(axis=1)
            hits = np.nonzero(dist <= SYNC_TOLERANCE)[0]
            if len(hits):
                return int(hits[0])
        return None


class ProVoiceReceiver:
    """Per-call collector: the role DSD plays for one logging_receiver
    (logging_receiver.py:334-351), minus audio synthesis.  Collects
    voice codewords and reports activity for hang-time keep-alive."""

    def __init__(self):
        self.framer = ProVoiceFramer()
        self.voice_frames: list[np.ndarray] = []
        self.superframes = 0
        self.variant: str | None = None

    def feed(self, bits: np.ndarray) -> int:
        """Returns the number of superframes extracted this call."""
        n = 0
        for fr in self.framer.feed(bits):
            n += 1
            self.superframes += 1
            self.variant = fr.variant
            self.voice_frames.extend(fr.voice)
        return n

    @property
    def sync_losses(self) -> int:
        return self.framer.sync_losses

    @property
    def cadence_bits(self) -> int:
        """Operating inter-sync stride (self-calibrated at runtime)."""
        return self.framer.stride

    @property
    def cadence_adapted(self) -> bool:
        return self.framer.cadence_adapted


# ---------------------------------------------------------------- encode
def build_superframe(voice: list[np.ndarray], variant: str = "pv",
                     inverted: bool = False,
                     aux: np.ndarray | None = None) -> np.ndarray:
    """Fixture encoder — exact inverse of :class:`ProVoiceFramer`."""
    name = variant + ("_inv" if inverted else "")
    chunks = [SYNC_PATTERNS[name]]
    body = []
    for j in range(VOICE_PER_SUPERFRAME):
        vc = (np.asarray(voice[j], np.uint8) if j < len(voice)
              else np.zeros(VOICE_BITS, np.uint8))
        assert len(vc) == VOICE_BITS
        body.append(vc)
    body.append(np.zeros(AUX_BITS, np.uint8) if aux is None
                else np.asarray(aux, np.uint8))
    b = np.concatenate(body)
    if inverted:
        b = b ^ 1
    chunks.append(b)
    return np.concatenate(chunks)


def build_stream(voice: list[np.ndarray], variant: str = "pv",
                 inverted: bool = False, lead_bits: int = 41,
                 seed: int = 99) -> np.ndarray:
    """Junk lead-in + enough superframes to carry ``voice``."""
    rng = np.random.default_rng(seed)
    chunks = [rng.integers(0, 2, lead_bits).astype(np.uint8)]
    for i in range(0, max(len(voice), 1), VOICE_PER_SUPERFRAME):
        chunks.append(build_superframe(
            voice[i:i + VOICE_PER_SUPERFRAME], variant, inverted))
    return np.concatenate(chunks)
