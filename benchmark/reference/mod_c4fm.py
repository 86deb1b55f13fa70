"""The traffic's c4fm modulator, found by the configuration's
``modulation``: seeded dibits → complex baseband at ``fs``."""

from benchmark.reference.modulators import c4fm_modulate as modulate

__all__ = ["modulate"]
