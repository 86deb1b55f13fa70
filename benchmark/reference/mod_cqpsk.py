"""The traffic's cqpsk modulator, found by the configuration's
``modulation``: seeded dibits → complex baseband at ``fs``."""

from benchmark.reference.modulators import cqpsk_modulate as modulate

__all__ = ["modulate"]
