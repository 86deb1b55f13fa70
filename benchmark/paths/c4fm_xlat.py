"""P25 C4FM control through the xlat frontend: ``ControlPipeline.step`` =
the wire bank (``XlatBank.call_planes``: ``bank_operands`` and
``xlat_bank``) then the fused tracker (``fsk_track``)."""

from benchmark.core.c4fm import C4fmPath


class Path(C4fmPath):
    frontend = "xlat"
    reference = "xlat"
    work = {"channelize": "xlat_bank", "demod": "fsk_track"}
