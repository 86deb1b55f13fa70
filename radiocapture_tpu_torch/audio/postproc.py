"""Per-call audio post-processing: sox EQ → lame mp3 → id3v2 tags.

Same contract as the reference's ``upload_and_cleanup``
(logging_receiver.py:477-522): per-modulation sox chains, 32 kbps mp3,
ID3 tags TIT2 (type + talkgroup), TPE1 (user), TALB (system), COMM
(channel, open time, patch groups with ':'→'|'). Each external tool is
gated on presence; when sox/lame/id3v2 are absent the wav is kept and
the tags land in a JSON sidecar so the CDR contract (filename + tags)
still holds.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import subprocess

log = logging.getLogger(__name__)

SOX_CHAINS = {
    # p25 digital audio gets the reference's speech EQ.
    "p25": ["gain", "-h", "equalizer", "0.25k", "0.5k", "-8",
            "equalizer", "0.75k", "0.5k", "-6",
            "equalizer", "1.25k", "0.5k", "-6",
            "contrast", "loudness", "gain", "-n", "-6", "dither"],
    # EDACS analog trims the leading squelch crash.
    "analog_edacs": ["gain", "-h", "trim", "0.2", "contrast", "loudness",
                     "gain", "-n", "-6", "dither"],
    # everything else
    "default": ["gain", "-h", "contrast", "loudness", "gain", "-n", "-6",
                "dither"],
}
_P25_MODS = ("p25", "p25_cqpsk", "p25_tdma", "p25_cqpsk_tdma")


def _have(tool: str) -> bool:
    return shutil.which(tool) is not None


def _run(args: list[str]) -> bool:
    try:
        subprocess.run(args, check=True, capture_output=True, timeout=120)
        return True
    except (subprocess.SubprocessError, OSError) as e:
        log.warning("postproc step %s failed: %s", args[0], e)
        return False


def build_tags(cdr: dict, patches: dict) -> dict:
    groups = []
    tg = cdr["system_group_local"]
    for patch_group, members in (patches or {}).items():
        if tg in members or tg == patch_group:
            groups.extend(members)
            groups.append(patch_group)
    groups = sorted(set(groups))
    comm = f"{cdr['system_channel_local']},{cdr['time_open']},{groups}"
    return {
        "TIT2": f"{cdr['type']} {tg}",
        "TPE1": f"{cdr['system_user_local']}",
        "TALB": f"{cdr['system_id']}",
        "COMM": comm.replace(":", "|"),
    }


def process_call_audio(wav_path: str, cdr: dict,
                       patches: dict | None = None,
                       keep_wav: bool = False) -> str:
    """Run the post chain; returns the final audio filename (mp3 when the
    toolchain exists, the original wav otherwise)."""
    base = wav_path[:-4] if wav_path.endswith(".wav") else wav_path
    tags = build_tags(cdr, patches or {})
    mod = cdr.get("modulation_type", "analog")
    chain = SOX_CHAINS["p25" if mod in _P25_MODS else mod] \
        if (mod in _P25_MODS or mod in SOX_CHAINS) else SOX_CHAINS["default"]

    sox_wav = base + "-sox.wav"
    staged = wav_path
    if _have("sox") and _run(["nice", "-n", "19", "sox", wav_path,
                              sox_wav, *chain]):
        staged = sox_wav

    final = wav_path
    if _have("lame") and _run(["nice", "-n", "19", "lame", "-b", "32",
                               "-q2", "--silent", staged, base + ".mp3"]):
        final = base + ".mp3"
        if _have("id3v2"):
            _run(["id3v2", "-2", "--TIT2", tags["TIT2"],
                  "--TPE1", tags["TPE1"], "--TALB", tags["TALB"],
                  "-c", f"RC:{tags['COMM']}:English", final])
        else:
            _write_sidecar(base, tags)
        if not keep_wav:
            for p in (wav_path, sox_wav):
                try:
                    os.remove(p)
                except OSError:
                    pass
    else:
        # No mp3 toolchain: keep the wav, tags go to a sidecar.
        _write_sidecar(base, tags)
        if staged != wav_path:
            try:
                os.remove(sox_wav)
            except OSError:
                pass
    return final


def _write_sidecar(base: str, tags: dict) -> None:
    with open(base + ".tags.json", "w") as f:
        json.dump(tags, f)


def audio_path(audio_dir: str, instance_uuid: str, talkgroup,
               call_uuid: str, t: float) -> str:
    """audio/Y/M/D/H/<instance>/<talkgroup>/<uuid>.wav — the reference's
    directory contract (logging_receiver.py:583-611)."""
    import datetime
    dt = datetime.datetime.fromtimestamp(t)
    return os.path.join(audio_dir, f"{dt.year}", f"{dt.month}",
                        f"{dt.day}", f"{dt.hour}", instance_uuid,
                        f"{talkgroup}", f"{call_uuid}.wav")
