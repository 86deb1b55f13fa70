"""Tiny cells for CPU runs of the harness: the named cell with 2 sources,
8 slots and a 10 ms block (4 ms at 10 MS/s)."""

from benchmark.core import spec


def cell(workload: str):
    c = spec.Cell(spec.manifest(), workload)
    c.cfg["slots"] = 8
    c.traffic.update(sources=2, ring_blocks=3, trace_blocks=3)
    c.traffic["block_s"] = 0.01 if c.traffic["samp_rate"] < 5e6 else 0.004
    return c


WORKLOADS = ("p25_c4fm.rtl_2m4", "p25_lsm_split2.rtl_2m4",
             "p25_c4fm.bladerf_10m_pfb")
