"""Scan CLI (port of ``radiocapture_tpu.scan.__main__``), the runnable
surface of the reference's scan tooling:

- ``fft`` mode = fft_based_scan.sh + fft_vector.py + fft_peak_detection.py:
  FFT-average a wideband IQ capture, find channel-shaped peaks, run a
  batched P25 trial-lock on each, write ``fft.scan.output`` lines
  (fft_peak_detection.py:83-106 record format via
  ``TrialResult.summary_line``).
- ``band`` mode = ov_scan.py:34-111: brute candidate grid across
  frequency ranges (default the reference's 768-775 & 850-863 MHz public
  -safety bands clipped to the capture's span), trial-locked in batches.

Input is a complex64 IQ file. Runs on the first CUDA device (a caller
of ``main`` may pass another ``device``).

    python -m radiocapture_tpu_torch.scan fft  capture.dat -r 2.4e6 -f 857e6
    python -m radiocapture_tpu_torch.scan band capture.dat -r 2.4e6 \
        -f 857e6 --ranges 856e6:858e6 --step 12.5e3 -o scan.output
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

from radiocapture_tpu_torch.device import resolve
from radiocapture_tpu_torch.scan.discovery import (average_offset,
                                                   band_scan_candidates,
                                                   trial_p25_lock)
from radiocapture_tpu_torch.scan.spectrum import (SpectrumScanner,
                                                  find_channels)

log = logging.getLogger("overseer.scan")


def _load_iq(path: str, max_samples: int | None) -> np.ndarray:
    x = np.fromfile(path, np.complex64)
    return x[:max_samples] if max_samples else x


def run_fft_scan(iq: np.ndarray, samp_rate: float, center: float,
                 block_syms: int = 512, device=None) -> list:
    dev = resolve(device)
    sc = SpectrumScanner()
    st = sc.init(dev)
    blk = sc.fft_len * 8
    for i in range(max(1, len(iq) // blk)):
        st = sc.step(st, np.stack([iq[i * blk:(i + 1) * blk].real,
                                   iq[i * blk:(i + 1) * blk].imag], -1))
    peaks = find_channels(sc.spectrum_db(st), samp_rate, center)
    log.info("%d channel-shaped peaks", len(peaks))
    cands = [p.frequency for p in peaks]
    if not cands:
        return []
    return trial_p25_lock(iq, samp_rate, center, cands,
                          block_syms=block_syms, device=dev)


def run_band_scan(iq: np.ndarray, samp_rate: float, center: float,
                  ranges: list[tuple[float, float]], step: float,
                  block_syms: int = 512, batch: int = 40,
                  device=None) -> list:
    dev = resolve(device)
    lo_cap = center - samp_rate / 2
    hi_cap = center + samp_rate / 2
    ranges = [(max(lo, lo_cap), min(hi, hi_cap)) for lo, hi in ranges]
    ranges = [(a, b) for a, b in ranges if a < b]
    cands = band_scan_candidates(ranges, step)
    log.info("%d candidates", len(cands))
    results = []
    # 40 parallel trial demods per pass (ov_scan.py:34).
    for i in range(0, len(cands), batch):
        results.extend(trial_p25_lock(iq, samp_rate, center,
                                      cands[i:i + batch],
                                      block_syms=block_syms, device=dev))
    return results


def main(argv=None, device=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("mode", choices=["fft", "band"])
    ap.add_argument("iq_file")
    ap.add_argument("-r", "--samp-rate", type=float, required=True)
    ap.add_argument("-f", "--center-freq", type=float, required=True)
    ap.add_argument("--ranges", default="768e6:775e6,850e6:863e6",
                    help="band mode: lo:hi[,lo:hi...] Hz")
    ap.add_argument("--step", type=float, default=12.5e3)
    ap.add_argument("--block-syms", type=int, default=512)
    ap.add_argument("--max-samples", type=int, default=None)
    ap.add_argument("-o", "--output", default=None,
                    help="write summary lines (fft.scan.output /"
                         " scan.output role); default stdout")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    dev = resolve(device)

    iq = _load_iq(args.iq_file, args.max_samples)
    if args.mode == "fft":
        results = run_fft_scan(iq, args.samp_rate, args.center_freq,
                               args.block_syms, device=dev)
    else:
        ranges = [tuple(float(x) for x in r.split(":"))
                  for r in args.ranges.split(",")]
        results = run_band_scan(iq, args.samp_rate, args.center_freq,
                                ranges, args.step, args.block_syms,
                                device=dev)

    out = open(args.output, "w") if args.output else sys.stdout
    try:
        for i, r in enumerate(results):
            print(r.summary_line(i), file=out)
        off = average_offset(results)
        if off is not None:
            print(f"# average locked offset: {off:.1f} Hz", file=out)
        n_locked = sum(r.locked for r in results)
        log.info("%d/%d candidates locked", n_locked, len(results))
    finally:
        if args.output:
            out.close()


if __name__ == "__main__":
    main()
