"""Longevity/leak check: SiteRuntime under continuous call churn.

The reference runs for days between watchdog restarts (watchdog.py:
85-107 restarts receivers after 24 h); this harness checks that the
runtime holds steady-state memory and thread counts under continuous
call lifecycle churn — open 8 calls, hold, hang-time close, repeat — on
one soak site (``tools/soak.py``: 1 source × 80 slots at 1 MS/s, two P25
systems, the stream clock), sampling every 10 cycles the process's
VmRSS and thread count, the calls still open and, on a CUDA device, the
allocator's ``memory_allocated`` and ``max_memory_allocated``. The
site's grant fence (``soak.GrantFence``) goes before the identifiers,
after each cycle's grants and before each sample, so the grants land in
the block they were sent for and a sample counts the calls whose close
the bus has delivered, not those whose close is still in flight.

Usage: ``python -m radiocapture_tpu_torch.tools.longevity [seconds]``
(the first CUDA device; ``main(seconds, device="cpu")`` from Python runs
the kernels' plain versions). Prints one line per sample and a JSON
summary last.
"""

from __future__ import annotations

import gc
import json
import sys
import tempfile
import threading
import time

import torch

SAMPLE_EVERY = 10          # cycles between samples
BLOCKS_ACTIVE = 10         # blocks of activity after the grants
BLOCKS_CLOSE = 55          # hang-time close + drain


def vmrss_mb() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) // 1024
    return -1


def sample(site, cycle: int, dev: torch.device) -> dict:
    site.fence.wait()       # the calls closed so far have been handled
    gc.collect()
    s = {"cycle": cycle, "rss_mb": vmrss_mb(),
         "threads": threading.active_count(),
         "active": len(site.rt.recorders.active)}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        s["cuda_allocated"] = torch.cuda.memory_allocated(dev)
        s["cuda_max_allocated"] = torch.cuda.max_memory_allocated(dev)
    return s


def main(duration_s: float = 420.0, device=None,
         audio_dir: str | None = None) -> dict:
    """Churn calls for ``duration_s`` wall seconds; returns the samples
    (one at cycle 0, after the first block, then every SAMPLE_EVERY
    cycles) and the summary."""
    from radiocapture_tpu_torch.control.resp import MiniRedisServer
    from radiocapture_tpu_torch.device import resolve
    from radiocapture_tpu_torch.tools.soak import _SoakSite

    dev = resolve(device)
    tmp = None
    if audio_dir is None:
        tmp = tempfile.TemporaryDirectory(prefix="rc_longevity_")
        audio_dir = tmp.name
    srv = MiniRedisServer()
    site = _SoakSite(0, 1, 1.0e6, 80, 2,
                     [{"host": srv.host, "port": srv.port}],
                     audio_dir, device=dev)
    samples = []
    try:
        site.fence.wait()   # the runtime's subscriptions are live
        site.publish_iden()
        site.rt.step()
        samples.append(sample(site, 0, dev))
        t0 = time.time()
        cycle = 0
        while time.time() - t0 < duration_s:
            for c in range(8):
                site.grant(c % 2, (cycle * 8 + c) % 70, 1000 + c)
            site.fence.wait()
            for _ in range(BLOCKS_ACTIVE + BLOCKS_CLOSE):
                site.rt.step()
                for cm in site.rt.call_managers.values():
                    cm.sweep()
            cycle += 1
            if cycle % SAMPLE_EVERY == 0:
                samples.append(sample(site, cycle, dev))
                print(json.dumps(samples[-1]), flush=True)
        last = sample(site, cycle, dev)
        if samples[-1]["cycle"] != cycle:
            samples.append(last)
    finally:
        site.close()
        srv.close()
        if tmp is not None:
            tmp.cleanup()
    res = {"device": str(dev), "seconds": duration_s, "cycles": cycle,
           "blocks": cycle * (BLOCKS_ACTIVE + BLOCKS_CLOSE) + 1,
           "rss_mb_start": samples[0]["rss_mb"],
           "rss_mb_end": last["rss_mb"],
           "threads_start": samples[0]["threads"],
           "threads_end": last["threads"],
           "active_end": last["active"], "samples": samples}
    print(json.dumps({k: v for k, v in res.items() if k != "samples"}),
          flush=True)
    return res


if __name__ == "__main__":
    main(float(sys.argv[1]) if len(sys.argv) > 1 else 420.0)
