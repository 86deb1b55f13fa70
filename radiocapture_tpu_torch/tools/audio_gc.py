"""Audio-tree maintenance: migrate finished mp3s, GC day-old scratch.

Replaces the reference's shell cron jobs (audio/cleanup.sh: delete
files older than a day + empty dirs; migrate-audio.sh: rsync mp3s to
the permanent tree, prune empties, GC stale .dat/.wav) as a portable
Python tool:

    python -m radiocapture_tpu_torch.tools.audio_gc audio/ \
        [--migrate-to audio-perm/] [--max-age-days 1] [--dry-run]
"""

from __future__ import annotations

import argparse
import os
import shutil
import time


def migrate_mp3s(audio_dir: str, perm_dir: str,
                 dry_run: bool = False) -> list[str]:
    """Move every finished artifact (.mp3 + its .tags.json sidecar) to
    the permanent tree, preserving the Y/M/D/H/instance/tg layout
    (migrate-audio.sh rsync --remove-source-files semantics)."""
    moved = []
    for root, _dirs, files in os.walk(audio_dir):
        for f in files:
            if not (f.endswith(".mp3") or f.endswith(".tags.json")):
                continue
            src = os.path.join(root, f)
            rel = os.path.relpath(src, audio_dir)
            dst = os.path.join(perm_dir, rel)
            if not dry_run:
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                shutil.move(src, dst)
            moved.append(rel)
    return moved


def gc_stale(audio_dir: str, max_age_days: float = 1.0,
             exts: tuple = (".dat", ".wav", ".imbe", ".vb"),
             dry_run: bool = False, now: float | None = None
             ) -> list[str]:
    """Delete scratch files older than ``max_age_days``
    (audio/cleanup.sh / migrate-audio.sh find -mtime +1)."""
    now = time.time() if now is None else now
    cutoff = now - max_age_days * 86400.0
    removed = []
    for root, _dirs, files in os.walk(audio_dir):
        for f in files:
            if not f.endswith(exts):
                continue
            p = os.path.join(root, f)
            try:
                if os.path.getmtime(p) < cutoff:
                    if not dry_run:
                        os.remove(p)
                    removed.append(os.path.relpath(p, audio_dir))
            except OSError:
                pass
    return removed


def prune_empty_dirs(audio_dir: str, dry_run: bool = False) -> int:
    """Bottom-up empty-directory sweep (one pass does what the
    reference's five repeated finds did)."""
    n = 0
    for root, dirs, files in os.walk(audio_dir, topdown=False):
        if root == audio_dir:
            continue
        if not dirs and not files or not os.listdir(root):
            if not dry_run:
                try:
                    os.rmdir(root)
                except OSError:
                    continue
            n += 1
    return n


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("audio_dir")
    ap.add_argument("--migrate-to", default=None)
    ap.add_argument("--max-age-days", type=float, default=1.0)
    ap.add_argument("--dry-run", action="store_true")
    args = ap.parse_args(argv)
    if args.migrate_to:
        moved = migrate_mp3s(args.audio_dir, args.migrate_to,
                             args.dry_run)
        print(f"migrated {len(moved)} artifacts")
    removed = gc_stale(args.audio_dir, args.max_age_days,
                       dry_run=args.dry_run)
    pruned = prune_empty_dirs(args.audio_dir, args.dry_run)
    print(f"removed {len(removed)} stale files, pruned {pruned} dirs")


if __name__ == "__main__":
    main()
