"""Read a ``torch.profiler`` trace of a few steady blocks: the device's busy
time (the union of its kernel and copy intervals), the operations that
took the most device time, and the longest idle gaps by the benchmark
span the host was in when the device went idle."""

from __future__ import annotations

import bisect

SPAN_PREFIX = "bench."


def _intervals(events, cuda_type) -> list:
    """The device's operations: kernels, copies and sets (the device-side
    ranges of the host's annotations are not operations)."""
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in events if e.device_type == cuda_type
                  and not e.name.startswith(SPAN_PREFIX)
                  and e.time_range.end > e.time_range.start)


def read(prof, top: int = 10) -> dict:
    """busy_s, window_s, device_ops and idle_gaps of the profiled segment;
    the profiler's microseconds become seconds. The segment runs from the
    first device operation to the end of the last (the device idles
    before the first block of the segment, whose host spans start with the
    profiler); the host span a gap begins in names it."""
    from torch.autograd import DeviceType
    events = prof.events()
    dev = _intervals(events, DeviceType.CUDA)
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in events if e.device_type == DeviceType.CPU
                   and e.name.startswith(SPAN_PREFIX))
    if not dev or not spans:
        return {"busy_s": 0.0, "window_s": 0.0, "device_ops": [],
                "idle_gaps": []}
    t_first = dev[0][0]
    t_last = max(e for _, e, _ in dev)
    busy, gaps = 0.0, []
    cur_s, cur_e = dev[0][0], dev[0][1]
    for s, e, _ in dev[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    by_name: dict = {}
    for s, e, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    starts = [sp[0] for sp in spans]

    def host_at(t: float) -> str:
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0:
            s, e, name = spans[i]
            if s <= t <= e:
                return name
            i -= 1
        return "bench.loop"

    longest = sorted(gaps, key=lambda g: -(g[1] - g[0]))[:top]
    return {"busy_s": busy * 1e-6, "window_s": (t_last - t_first) * 1e-6,
            "device_ops": [[n, v * 1e-6] for n, v in ops],
            "idle_gaps": [[host_at(s), (e - s) * 1e-6] for s, e in longest]}
