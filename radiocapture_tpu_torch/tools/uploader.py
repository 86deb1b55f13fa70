"""Queued call uploader — the role of the reference's external
``radiocapture-uploader/queued_upload.py`` consumed from the durable
``/queue/call_management/call_complete`` queue
(systemd/radiocapture-upload.service; logging_receiver.py:550 producer).

Two modes, composable:

- **Bus mode** (service): subscribe to the durable call_complete queue
  and deliver each finished call (mp3 + CDR JSON sidecar) to the
  destination as it completes.
- **Spool mode** (cron/timer, or catch-up after downtime): sweep the
  audio tree for finished mp3s whose CDR sidecar exists and deliver
  any not yet uploaded — the at-least-once backstop the reference gets
  from ActiveMQ persistence.

"Deliver" = atomic move into ``--dest`` preserving the
``Y/M/D/H/instance/talkgroup/`` layout, or a user command template
(``--cmd 'rsync -a {src} host:{rel}'``) for remote destinations.

Usage::

    python -m radiocapture_tpu_torch.tools.uploader --audio-dir audio \
        --dest /srv/rc-upload [--spool-only] [--cmd 'rsync -a {src} ...']
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shlex
import shutil
import subprocess
import time

log = logging.getLogger("overseer.uploader")


def _deliver(src: str, rel: str, dest: str | None, cmd: str | None,
             dry_run: bool = False) -> bool:
    if dry_run:
        log.info("would deliver %s -> %s", src, rel)
        return True
    if cmd:
        c = cmd.format(src=shlex.quote(src), rel=shlex.quote(rel))
        r = subprocess.run(c, shell=True)
        if r.returncode != 0:
            log.error("upload command failed (%s): %s", r.returncode, c)
            return False
        os.remove(src)
        return True
    out = os.path.join(dest, rel)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    shutil.move(src, out)
    return True


def deliver_call(filename: str, cdr: dict, audio_dir: str,
                 dest: str | None, cmd: str | None,
                 dry_run: bool = False) -> bool:
    """Deliver one finished call: its audio file plus a ``.cdr.json``
    sidecar carrying the CDR (the reference posts the CDR in the queue
    message; a file sidecar keeps the pair atomic for file transports)."""
    if not os.path.exists(filename):
        log.warning("call_complete for missing file %s", filename)
        return False
    rel = os.path.relpath(filename, audio_dir)
    side = filename + ".cdr.json"
    with open(side, "w") as f:
        json.dump(cdr, f, default=str)
    ok = _deliver(filename, rel, dest, cmd, dry_run)
    if ok:
        ok = _deliver(side, rel + ".cdr.json", dest, cmd, dry_run)
    return ok


def sweep_spool(audio_dir: str, dest: str | None, cmd: str | None,
                min_age_s: float = 30.0, dry_run: bool = False) -> int:
    """Spool mode: deliver every finished mp3 older than ``min_age_s``
    (age guard so in-flight post-processing is never raced)."""
    n = 0
    now = time.time()
    for root, _dirs, files in os.walk(audio_dir):
        for f in files:
            if not f.endswith(".mp3"):
                continue
            p = os.path.join(root, f)
            try:
                if now - os.path.getmtime(p) < min_age_s:
                    continue
            except OSError:
                continue
            tags = p[:-4] + ".tags.json"
            cdr = {}
            if os.path.exists(tags):
                with open(tags) as fh:
                    cdr = json.load(fh)
            if deliver_call(p, cdr, audio_dir, dest, cmd, dry_run):
                if os.path.exists(tags) and not dry_run:
                    os.remove(tags)
                n += 1
    return n


class Uploader:
    """Bus-mode service object: wire to any control bus."""

    def __init__(self, bus, audio_dir: str, dest: str | None = None,
                 cmd: str | None = None):
        self.audio_dir = audio_dir
        self.dest = dest
        self.cmd = cmd
        self.delivered = 0
        bus.subscribe("/queue/call_management/call_complete", self._on_call)

    def _on_call(self, ev: dict) -> None:
        fn = ev.get("filename")
        if fn and deliver_call(fn, ev.get("cdr", {}), self.audio_dir,
                               self.dest, self.cmd):
            self.delivered += 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--audio-dir", default="audio")
    ap.add_argument("--dest", default=None,
                    help="local destination tree (atomic move)")
    ap.add_argument("--cmd", default=None,
                    help="upload command template with {src}/{rel}")
    ap.add_argument("--min-age", type=float, default=30.0)
    ap.add_argument("--interval", type=float, default=60.0,
                    help="spool sweep period; 0 = one-shot")
    ap.add_argument("--dry-run", action="store_true")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if not (args.dest or args.cmd or args.dry_run):
        ap.error("need --dest or --cmd")
    while True:
        n = sweep_spool(args.audio_dir, args.dest, args.cmd,
                        args.min_age, args.dry_run)
        log.info("delivered %d calls", n)
        if not args.interval:
            return
        time.sleep(args.interval)


if __name__ == "__main__":
    main()
