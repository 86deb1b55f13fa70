"""A stage's share of its roofline: the least time the card could take
for the stage's work (``work/<stage>.py``: FLOP by precision over the
matching peak, summed, against bytes over the HBM rate; the larger)
over the stage's mean device time in the traced window."""

from __future__ import annotations

from benchmark.core.spec import BENCH, load_json

PEAKS = load_json(BENCH / "peaks.json")


def least_s(work: dict) -> float:
    t_ops = sum(f / PEAKS["flop_per_s"][p] for p, f in work["flop"].items())
    return max(t_ops, work["bytes"] / PEAKS["hbm_bytes_per_s"])


def share(ctx: dict, stage: str) -> float | None:
    ms = ctx["probe"].stage_ms(stage)
    if not ms or stage not in ctx["work"]:
        return None
    mean_s = sum(ms) / len(ms) / 1e3
    if mean_s <= 0.0:
        return None
    return 100.0 * least_s(ctx["work"][stage]) / mean_s
