"""P25 Phase 2 TDMA voice-channel air interface (TIA-102.BBAC).

The reference delegates Phase 2 entirely to op25's C++
``p25_frame_assembler`` with ``phase2_tdma=True``: the per-call
receiver sets the scrambler xormask from ``p25p2_lfsr(nac, sysid,
wacn)`` and the wanted slot id, and the assembler does sync search,
descrambling, slot demux, and voice extraction
(logging_receiver.py:353-363, 317-321).  This module is that layer,
host-side, consuming the 6000 Bd dibit stream the CQPSK pipeline
produces.

Air-interface structure (published TIA-102.BBAC geometry, as used by
every open implementation):

* 12000 bps / 6000 symbols per second, H-DQPSK outbound.
* **Superframe** = 4320 bits = 2160 dibits = 360 ms = 12 bursts.  This
  equals the descrambler LFSR period (``fec.lfsr``, proven
  bit-identical to the reference's p25p2_lfsr.py in
  tests/test_reference_parity.py).
* **Burst** = 180 dibits = 30 ms: a 20-dibit (40-bit) inter-slot
  signalling channel (ISCH) followed by a 160-dibit (320-bit) timeslot
  payload.  Bursts alternate logical channels: even burst index ->
  TDMA channel 0, odd -> channel 1.
* **S-ISCH**: the ISCH of every even burst is the published 40-bit
  Phase 2 frame sync ``0x575D57F7FF`` (only outer-deviation symbols,
  like the Phase 1 sync), transmitted in clear.
* **I-ISCH**: the ISCH of every odd burst is an informational
  codeword carrying (channel number, ISCH location within the
  superframe, half-superframe flag, 4-bit superframe counter) — enough
  to recover absolute scrambler alignment from any single burst pair.
  Field semantics and the (40,9,16)-code framing follow the standard;
  the concrete generator matrix (``_IISCH_GEN``) is CONJECTURAL — the
  standard's code table is not reproduced in any source available to
  this build, so this build uses a [40,9,14] linear code (shortened-
  Golay juxtaposition, hill-climbed; weight enumerator starts
  28·z^14 + 104·z^15) decoded by exhaustive nearest-codeword over all
  512 words, correcting up to 5 bit errors.  Codewords are whitened
  with the 0x184229D461 mask; every whitened codeword is ≥10 bits
  (≥5 dibits) from the S-ISCH sync, so I-ISCH never aliases the sync
  even at the 2-dibit sync-match tolerance.
* **Burst schedule** (per superframe): bursts 0-7 are 4V voice bursts,
  8-9 are 2V voice bursts, 10-11 are SACCH signalling bursts.  Per
  channel that is 4x4V + 1x2V = 18 voice codewords per 360 ms — one
  AMBE+2 codeword per 20 ms, the published vocoder cadence.
* **4V payload** (320 bits): four 72-bit voice codewords (288) +
  24-bit ESS-B fragment + 8 reserved bits.
* **2V payload**: two voice codewords (144) + 96-bit ESS-A
  (MI 72, ALGID 8, KeyID 16) + 80 reserved bits.
* **SACCH payload**: one 320-bit MAC PDU; first octet is the MAC
  opcode (PTT / END_PTT / IDLE / ACTIVE / HANGTIME vocabulary used by
  open trunking implementations).
* **Scrambling**: the 4320-bit-per-superframe keystream is indexed by
  absolute superframe bit position and applied to timeslot payloads
  only; ISCH fields ride in clear (the sync must be detectable before
  the key is known).  Keystream bits falling on ISCH positions are
  skipped.

AMBE+2 audio synthesis is intentionally out of scope (the native
vocoder covers IMBE/Phase 1); voice codewords are captured raw so
recordings keep evidentiary value (``CallRecorder`` writes them to a
``.vb`` sidecar).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from radiocapture_tpu_torch.fec import bits as B
from radiocapture_tpu_torch.fec import lfsr as L

BURST_DIBITS = 180            # 360 bits, 30 ms
SUPERFRAME_BURSTS = 12        # 4320 bits scrambling period
SUPERFRAME_DIBITS = BURST_DIBITS * SUPERFRAME_BURSTS   # 2160
N_ISCH = 20                   # dibits
PAYLOAD_DIBITS = BURST_DIBITS - N_ISCH                 # 160 (320 bits)

# Published 40-bit Phase 2 frame sync (S-ISCH).
SYNC_MAGIC = 0x575D57F7FF
SYNC_DIBITS = B.bits_to_dibits(np.array(
    [(SYNC_MAGIC >> (39 - i)) & 1 for i in range(40)], np.uint8))

# I-ISCH whitening mask (constant used by open implementations).
ISCH_MASK = 0x184229D461

BURST_4V = 0
BURST_2V = 1
BURST_SACCH = 2

#: burst kind by absolute superframe burst index
BURST_SCHEDULE = (BURST_4V,) * 8 + (BURST_2V,) * 2 + (BURST_SACCH,) * 2

VOICE_BITS = 72               # one AMBE+2 voice codeword
ESS_B_BITS = 24               # per-4V-burst encryption-sync fragment
ESS_A_BITS = 96               # 2V burst: MI(72) + ALGID(8) + KID(16)

# MAC PDU opcodes (vocabulary shared by open trunking implementations).
MAC_PTT = 0x01
MAC_END_PTT = 0x02
MAC_IDLE = 0x03
MAC_ACTIVE = 0x04
MAC_HANGTIME = 0x07


# ------------------------------------------------------------------ ISCH
# CONJECTURAL [40,9,14] I-ISCH generator (see module docstring): rows
# are 40-bit ints, row i encodes info bit 8-i (MSB-first messages).
# Derived from the [21,9,8] thrice-shortened extended Golay code
# juxtaposed with a 2-column puncture of itself, then hill-climbed for
# minimum distance (d=14, 28 minimum-weight words).
_IISCH_GEN = (
    0x803DA007B4, 0x401ED003DA, 0x206CCC0D99, 0x10366A06CD,
    0x081B390367, 0x046E308DC6, 0x0254B84A97, 0x0149F0293E,
    0x00C75818EB,
)
_ISCH_MASK_BITS = np.array(
    [(ISCH_MASK >> (39 - i)) & 1 for i in range(40)], np.uint8)


def _iisch_codebook() -> np.ndarray:
    """All 512 unwhitened codewords as a [512, 40] uint8 bit matrix."""
    gen = np.array([[(r >> (39 - j)) & 1 for j in range(40)]
                    for r in _IISCH_GEN], np.uint8)          # [9, 40]
    msgs = np.arange(512)
    mb = ((msgs[:, None] >> (8 - np.arange(9))[None, :]) & 1
          ).astype(np.uint8)                                  # [512, 9]
    return (mb @ gen) % 2


_IISCH_CODEBOOK = _iisch_codebook()

#: nearest-codeword decode radius — d=14 corrects 6; stop at 5 so junk
#: ISCH windows (expected distance ~20) essentially never false-decode.
IISCH_MAX_ERRORS = 5


def isch_encode(chn: int, loc: int, fr: int, cnt: int) -> np.ndarray:
    """I-ISCH: 9 info bits -> 40-bit codeword -> 20 dibits.

    info = chn(2) | loc(2) | fr(1) | cnt(4), encoded by the [40,9,14]
    ``_IISCH_GEN`` code and XOR-whitened with ISCH_MASK.  See module
    docstring for the conjectural-generator caveat."""
    info9 = ((chn & 3) << 7) | ((loc & 3) << 5) | ((fr & 1) << 4) | (cnt & 0xF)
    cw = _IISCH_CODEBOOK[info9]
    return B.bits_to_dibits(cw ^ _ISCH_MASK_BITS)


def isch_decode(dibits20: np.ndarray
                ) -> tuple[int, int, int, int] | None:
    """Inverse of isch_encode: exhaustive nearest-codeword over the
    512-word codebook, accepting up to IISCH_MAX_ERRORS bit errors."""
    bits = B.dibits_to_bits(np.asarray(dibits20, np.uint8))
    cw = bits ^ _ISCH_MASK_BITS
    dists = (_IISCH_CODEBOOK != cw[None, :]).sum(axis=1)
    info9 = int(np.argmin(dists))
    if int(dists[info9]) > IISCH_MAX_ERRORS:
        return None
    return ((info9 >> 7) & 3, (info9 >> 5) & 3,
            (info9 >> 4) & 1, info9 & 0xF)


def _iisch_for_burst(i: int, superframe: int) -> np.ndarray:
    """I-ISCH dibits for odd burst index i (1,3,..,11): loc/fr encode
    the pair position so a receiver can re-anchor from one pair."""
    assert i % 2 == 1
    fr = i // 6
    loc = (i % 6) // 2
    return isch_encode(chn=1, loc=loc, fr=fr, cnt=superframe & 0xF)


def _burst_index_from_iisch(loc: int, fr: int) -> int:
    """Absolute odd-burst index encoded by (loc, fr)."""
    return 6 * fr + 2 * loc + 1


# ------------------------------------------------------------------ MAC
def parse_mac(bits320: np.ndarray) -> dict:
    """SACCH MAC PDU: opcode octet + opcode-specific fields.  The
    trunking-relevant messages carry the talkgroup/source this capture
    platform tags recordings with."""
    b = np.asarray(bits320, np.uint8)
    op = B.bits_to_int(b[:8])
    r: dict = {"opcode": op}
    if op == MAC_PTT:
        r["name"] = "MAC_PTT"
        r["mi"] = B.hexstr(b[8:80])
        r["algid"] = B.bits_to_int(b[80:88])
        r["keyid"] = B.bits_to_int(b[88:104])
        r["tgid"] = B.bits_to_int(b[104:120])
        r["source"] = B.bits_to_int(b[120:144])
    elif op == MAC_END_PTT:
        r["name"] = "MAC_END_PTT"
        r["tgid"] = B.bits_to_int(b[8:24])
        r["source"] = B.bits_to_int(b[24:48])
    elif op == MAC_IDLE:
        r["name"] = "MAC_IDLE"
    elif op == MAC_ACTIVE:
        r["name"] = "MAC_ACTIVE"
    elif op == MAC_HANGTIME:
        r["name"] = "MAC_HANGTIME"
        r["tgid"] = B.bits_to_int(b[8:24])
    else:
        r["name"] = "MAC_UNKNOWN"
    return r


def make_mac(opcode: int, mi: int = 0, algid: int = 0, keyid: int = 0,
             tgid: int = 0, source: int = 0) -> np.ndarray:
    """Fixture encoder for a 320-bit MAC PDU."""
    b = np.zeros(320, np.uint8)
    b[:8] = B.int_to_bits(opcode, 8)
    if opcode == MAC_PTT:
        b[8:80] = B.int_to_bits(mi, 72)
        b[80:88] = B.int_to_bits(algid, 8)
        b[88:104] = B.int_to_bits(keyid, 16)
        b[104:120] = B.int_to_bits(tgid, 16)
        b[120:144] = B.int_to_bits(source, 24)
    elif opcode == MAC_END_PTT:
        b[8:24] = B.int_to_bits(tgid, 16)
        b[24:48] = B.int_to_bits(source, 24)
    elif opcode == MAC_HANGTIME:
        b[8:24] = B.int_to_bits(tgid, 16)
    return b


# ----------------------------------------------------------------- burst
@dataclass
class Burst:
    slot: int                 # TDMA channel: 0 | 1 (= burst index & 1)
    kind: int                 # BURST_4V | BURST_2V | BURST_SACCH
    seq: int                  # absolute burst index in the superframe
    voice: list = field(default_factory=list)   # [72-bit np arrays]
    ess: np.ndarray | None = None     # raw ESS-A/ESS-B bits
    mac: np.ndarray | None = None     # raw 320-bit SACCH payload
    mac_msg: dict | None = None


def _parse_payload(bits320: np.ndarray, seq: int) -> Burst:
    kind = BURST_SCHEDULE[seq]
    b = Burst(slot=seq & 1, kind=kind, seq=seq)
    if kind == BURST_4V:
        b.voice = [bits320[i * VOICE_BITS:(i + 1) * VOICE_BITS].copy()
                   for i in range(4)]
        b.ess = bits320[288:288 + ESS_B_BITS].copy()
    elif kind == BURST_2V:
        b.voice = [bits320[i * VOICE_BITS:(i + 1) * VOICE_BITS].copy()
                   for i in range(2)]
        b.ess = bits320[144:144 + ESS_A_BITS].copy()
    else:
        b.mac = bits320.copy()
        b.mac_msg = parse_mac(bits320)
    return b


#: S-ISCH match tolerance in dibit-symbol errors.  Real C4FM/H-DQPSK
#: flips symbols at usable SNR, so sync matching is a correlation with
#: a threshold (like the reference's C++ assembler), not an exact
#: compare.  ≤2 keeps a ≥3-dibit margin to every whitened I-ISCH word.
SYNC_TOLERANCE = 2

#: trial-alignment trigger and hold cap: one superframe of burst pairs.
#: Six pairs guarantee the held window covers the SACCH pair (bursts
#: 10-11) under every phase hypothesis, and bound the unaligned hold so
#: a stream whose I-ISCH never decodes can't grow memory without limit.
TRIAL_PAIRS = SUPERFRAME_BURSTS // 2

_VALID_MAC_OPS = frozenset(
    (MAC_PTT, MAC_END_PTT, MAC_IDLE, MAC_ACTIVE, MAC_HANGTIME))


class TdmaFramer:
    """Streaming S-ISCH sync search + I-ISCH alignment recovery +
    payload descramble + burst parse for one 6000 Bd dibit stream
    (both TDMA channels).

    Sync matching tolerates up to SYNC_TOLERANCE dibit errors, and
    burst pairs that arrive before absolute alignment is known are held
    (not dropped): when a later I-ISCH decodes, pending pairs are
    descrambled retroactively at their now-known superframe positions
    and emitted in order.

    **Trial-alignment fallback** (for the real-off-air case where the
    standard's I-ISCH code table — conjectural in this build, see module
    docstring — never decodes): once ``TRIAL_PAIRS`` pairs are held, all
    six even-burst phase hypotheses are scored by descrambling the held
    window at each hypothesis and checking the structure the standard
    gives for free — a valid MAC opcode octet on *both* timeslots'
    SACCH bursts (10-11).  The unique best hypothesis (score ≥ 2) locks
    alignment and the held pairs emit retroactively; otherwise the
    oldest pair is dropped (``dropped_unaligned``) so the hold stays
    bounded at one superframe.  ``fallback_aligns`` counts locks won
    this way; ``unaligned_pairs`` is the current hold depth."""

    def __init__(self, nac: int, sysid: int, wacn: int):
        self.key = L.keystream_dibits(nac, sysid, wacn)   # [2160]
        self._buf = np.zeros(0, np.uint8)
        self._synced = False
        self._even_idx: int | None = None  # superframe index of buf[0]
        self._pending: list[np.ndarray] = []  # unaligned raw pairs
        self.errors = 0
        self.fallback_aligns = 0      # alignments won by trial descramble
        self.dropped_unaligned = 0    # pairs dropped at the hold cap

    @property
    def unaligned_pairs(self) -> int:
        return len(self._pending)

    def feed(self, dibits: np.ndarray) -> list[Burst]:
        self._buf = np.concatenate(
            [self._buf, np.asarray(dibits, np.uint8)])
        out: list[Burst] = []
        while True:
            if not self._synced:
                self._pending.clear()
                idx = self._find_sync(self._buf)
                if idx is None:
                    keep = max(0, len(self._buf) - N_ISCH + 1)
                    self._buf = self._buf[keep:]
                    return out
                self._buf = self._buf[idx:]
                self._synced = True
                self._even_idx = None
            # process one burst PAIR: even (sync) burst + odd burst —
            # the odd burst's I-ISCH fixes absolute alignment.
            if len(self._buf) < 2 * BURST_DIBITS:
                return out
            pair = self._buf[:2 * BURST_DIBITS]
            if int((pair[:N_ISCH] != SYNC_DIBITS).sum()) > SYNC_TOLERANCE:
                self._synced = False
                self.errors += 1
                self._buf = self._buf[1:]
                continue
            hdr = isch_decode(pair[BURST_DIBITS:BURST_DIBITS + N_ISCH])
            if hdr is not None:
                _chn, loc, fr, _cnt = hdr
                self._even_idx = _burst_index_from_iisch(loc, fr) - 1
                # retroactively place any pairs held while unaligned:
                # pending[j] sits 2·(len-j) bursts before this pair.
                for j, held in enumerate(self._pending):
                    base = (self._even_idx
                            - 2 * (len(self._pending) - j)
                            ) % SUPERFRAME_BURSTS
                    out.extend(self._emit_pair(held, base))
                self._pending.clear()
            elif self._even_idx is not None:
                self._even_idx = (self._even_idx + 2) % SUPERFRAME_BURSTS
            else:
                # synced but not yet aligned: hold the pair for
                # retroactive descramble once an I-ISCH decodes.
                self._pending.append(pair.copy())
                self._buf = self._buf[2 * BURST_DIBITS:]
                if len(self._pending) >= TRIAL_PAIRS:
                    base = self._trial_align()
                    if base is not None:
                        self.fallback_aligns += 1
                        for j, held in enumerate(self._pending):
                            out.extend(self._emit_pair(
                                held,
                                (base + 2 * j) % SUPERFRAME_BURSTS))
                        # _even_idx holds the LAST emitted pair's even
                        # seq; the next pair advances by 2 above.
                        self._even_idx = (
                            base + 2 * (len(self._pending) - 1)
                        ) % SUPERFRAME_BURSTS
                        self._pending.clear()
                    else:
                        self._pending.pop(0)
                        self.dropped_unaligned += 1
                continue
            out.extend(self._emit_pair(pair, self._even_idx))
            self._buf = self._buf[2 * BURST_DIBITS:]

    def _trial_align(self) -> int | None:
        """Score the six even-burst phase hypotheses against the held
        window; return the winning base even-index or None.

        Under hypothesis h the oldest held pair's even burst is
        ``2h``; the pair that lands on (10, 11) is descrambled and both
        timeslots' SACCH MAC opcode octets are checked against the
        known vocabulary.  The correct phase yields 2 valid opcodes per
        superframe; a wrong phase descrambles mid-keystream noise whose
        first octet matches the 5-opcode vocabulary with p ≈ 2% per
        burst — requiring score ≥ 2 *and* a unique maximum makes a
        false lock vanishingly unlikely while one superframe of real
        signal is enough to win."""
        scores = [0] * (SUPERFRAME_BURSTS // 2)
        for h in range(len(scores)):
            for j, held in enumerate(self._pending):
                e = (2 * h + 2 * j) % SUPERFRAME_BURSTS
                for k in (0, 1):
                    seq = e + k
                    if BURST_SCHEDULE[seq] != BURST_SACCH:
                        continue
                    payload = held[k * BURST_DIBITS + N_ISCH:
                                   (k + 1) * BURST_DIBITS]
                    bits = self._descramble(payload, seq)
                    if B.bits_to_int(bits[:8]) in _VALID_MAC_OPS:
                        scores[h] += 1
        best = max(scores)
        if best >= 2 and scores.count(best) == 1:
            return 2 * int(scores.index(best))
        return None

    def _emit_pair(self, pair: np.ndarray, even_idx: int) -> list[Burst]:
        bursts = []
        for k in (0, 1):
            seq = (even_idx + k) % SUPERFRAME_BURSTS
            payload = pair[k * BURST_DIBITS + N_ISCH:
                           (k + 1) * BURST_DIBITS]
            bursts.append(_parse_payload(self._descramble(payload, seq),
                                         seq))
        return bursts

    def _descramble(self, payload_dibits: np.ndarray,
                    seq: int) -> np.ndarray:
        """XOR with the keystream dibits at the payload's absolute
        superframe positions (ISCH positions skipped — clear on air)."""
        off = seq * BURST_DIBITS + N_ISCH
        clear = payload_dibits ^ self.key[off:off + PAYLOAD_DIBITS]
        return B.dibits_to_bits(clear)

    @staticmethod
    def _find_sync(buf: np.ndarray) -> int | None:
        if len(buf) < N_ISCH:
            return None
        win = np.lib.stride_tricks.sliding_window_view(buf, N_ISCH)
        hits = np.nonzero(
            (win != SYNC_DIBITS).sum(axis=1) <= SYNC_TOLERANCE)[0]
        return int(hits[0]) if len(hits) else None


# ---------------------------------------------------------------- encode
def build_superframe(nac: int, sysid: int, wacn: int,
                     voice: dict[int, list[np.ndarray]],
                     mac: dict[int, np.ndarray] | None = None,
                     superframe: int = 0,
                     ess_a: dict[int, np.ndarray] | None = None
                     ) -> np.ndarray:
    """One 2160-dibit superframe.  ``voice[chn]`` supplies up to 18
    codewords (72 bits each) for TDMA channel chn; ``mac[chn]`` the
    320-bit SACCH payload; ``ess_a[chn]`` the 96-bit encryption sync
    (MI 72 + ALGID 8 + KeyID 16) carried by the channel's 2V burst.
    Inverse of :class:`TdmaFramer`."""
    key = L.keystream_dibits(nac, sysid, wacn)
    mac = mac or {}
    ess_a = ess_a or {}
    vq = {0: list(voice.get(0, [])), 1: list(voice.get(1, []))}
    chunks = []
    for i in range(SUPERFRAME_BURSTS):
        kind = BURST_SCHEDULE[i]
        chn = i & 1
        bits = np.zeros(PAYLOAD_DIBITS * 2, np.uint8)
        if kind in (BURST_4V, BURST_2V):
            nvc = 4 if kind == BURST_4V else 2
            for j in range(nvc):
                vc = (vq[chn].pop(0) if vq[chn]
                      else np.zeros(VOICE_BITS, np.uint8))
                bits[j * VOICE_BITS:(j + 1) * VOICE_BITS] = vc
            if kind == BURST_2V and chn in ess_a:
                bits[144:144 + ESS_A_BITS] = np.asarray(
                    ess_a[chn], np.uint8)
        else:
            payload = mac.get(chn)
            if payload is None:
                payload = make_mac(MAC_ACTIVE)
            bits[:] = payload
        payload_d = B.bits_to_dibits(bits)
        off = i * BURST_DIBITS + N_ISCH
        payload_d = payload_d ^ key[off:off + PAYLOAD_DIBITS]
        isch = (SYNC_DIBITS if i % 2 == 0
                else _iisch_for_burst(i, superframe))
        chunks.append(np.concatenate([isch, payload_d]))
    return np.concatenate(chunks)


def build_tdma_stream(nac: int, sysid: int, wacn: int,
                      voice: dict[int, list[np.ndarray]],
                      mac: dict[int, np.ndarray] | None = None,
                      n_superframes: int = 1,
                      lead_dibits: int = 37,
                      ess_a: dict[int, np.ndarray] | None = None
                      ) -> np.ndarray:
    """Fixture stream: junk lead-in + n scrambled superframes.  Voice
    codewords are consumed across superframes (18 per channel each)."""
    rng = np.random.default_rng(1234)
    vq = {0: list((voice or {}).get(0, [])),
          1: list((voice or {}).get(1, []))}
    chunks = [rng.integers(0, 4, lead_dibits).astype(np.uint8)]
    for sf in range(n_superframes):
        take = {c: vq[c][:18] for c in (0, 1)}
        for c in (0, 1):
            vq[c] = vq[c][18:]
        chunks.append(build_superframe(nac, sysid, wacn, take, mac,
                                       superframe=sf, ess_a=ess_a))
    return np.concatenate(chunks)


class TdmaVoiceReceiver:
    """Per-call slot filter: the role the configured frame assembler
    plays for one ``logging_receiver`` (slot id + xormask,
    logging_receiver.py:353-363).  Collects the wanted channel's voice
    codewords and reports activity; MAC END_PTT/IDLE on the channel's
    SACCH marks call end (parity with the reference's p25_sensor TLC
    teardown, logging_receiver.py:381-473)."""

    def __init__(self, nac: int, sysid: int, wacn: int, slot: int):
        self.framer = TdmaFramer(nac, sysid, wacn)
        self.slot = int(slot)
        self.voice_frames: list[np.ndarray] = []
        self.bursts = 0
        self.ended = False
        self.last_mac: dict | None = None
        #: latest ESS-A seen on our slot's 2V burst: {"mi", "algid",
        #: "keyid"} — tags encrypted calls at capture time (ALGID 0x80
        #: = clear per TIA-102; anything else means the voice codewords
        #: are ciphertext). The reference never surfaced this.
        self.ess: dict | None = None

    def feed(self, dibits: np.ndarray) -> int:
        """Returns the number of voice bursts seen for our slot."""
        n = 0
        for b in self.framer.feed(dibits):
            if b.slot != self.slot:
                continue
            self.bursts += 1
            if b.voice:
                n += 1
                self.voice_frames.extend(b.voice)
            if b.kind == BURST_2V and b.ess is not None \
                    and len(b.ess) == ESS_A_BITS:
                self.ess = {"mi": B.bits_to_int(b.ess[:72]),
                            "algid": B.bits_to_int(b.ess[72:80]),
                            "keyid": B.bits_to_int(b.ess[80:96])}
            if b.mac_msg is not None:
                self.last_mac = b.mac_msg
                if b.mac_msg["opcode"] in (MAC_END_PTT, MAC_IDLE):
                    self.ended = True
        return n

    @property
    def errors(self) -> int:
        return self.framer.errors

    @property
    def fallback_aligns(self) -> int:
        return self.framer.fallback_aligns

    @property
    def unaligned_pairs(self) -> int:
        return self.framer.unaligned_pairs
