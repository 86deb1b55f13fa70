"""Receiver clock-drift measurement from a reference carrier.

The reference measures per-dongle clock error by running LTE CellSearch
against a known cell and exporting the ppm to telegraf
(util/measure_drift.sh, util/measure_drift_telegraf.sh); the number
feeds each source's ``offset`` config field (rc_frontend/receiver.py
per-dongle ppm). Here the same measurement runs on any recorded IQ
capture containing a known strong carrier (an LTE center, a broadcast
pilot, a trunking control channel): extract the carrier, estimate its
apparent frequency per window from the discriminator phase slope, and
report the clock error in ppm plus its linear drift rate.

CLI::

    python -m radiocapture_tpu_torch.tools.measure_drift capture.cf32 \
        --samp-rate 2.4e6 --center 857e6 --carrier 857.5e6

Prints one JSON line: {"ppm", "ppm_drift_per_hour", "offset_hz",
"windows": [...]} — the ``ppm`` value drops straight into
``SourceConfig.offset`` (and the telegraf line protocol form is
available with --telegraf, mirroring measure_drift_telegraf.sh).
"""

from __future__ import annotations

import json

import numpy as np


def estimate_carrier_offset(iq: np.ndarray, fs: float,
                            offset_hz: float,
                            bw_hz: float = 25000.0) -> float:
    """Apparent frequency error (Hz) of a carrier expected at
    ``offset_hz`` from the capture center: extract ±bw/2 around it and
    measure the residual discriminator DC."""
    n = len(iq)
    mix = iq * np.exp(-2j * np.pi * offset_hz / fs * np.arange(n))
    decim = max(1, int(fs // (2 * bw_hz)))
    # cheap boxcar anti-alias + decimate (adequate for a dominant carrier)
    usable = (n // decim) * decim
    x = mix[:usable].reshape(-1, decim).mean(axis=1)
    d = x[1:] * np.conj(x[:-1])
    return float(np.angle(d.sum()) * (fs / decim) / (2 * np.pi))


def measure_drift(iq: np.ndarray, fs: float, carrier_offset_hz: float,
                  carrier_freq_hz: float, window_s: float = 1.0,
                  bw_hz: float = 25000.0) -> dict:
    """Windowed clock-error measurement over a capture.

    Returns ppm (mean clock error, positive = receiver clock fast),
    ppm_drift_per_hour (linear fit over windows), offset_hz, windows.
    """
    wlen = max(1024, int(fs * window_s))
    n_win = max(1, len(iq) // wlen)
    times, offs = [], []
    for w in range(n_win):
        seg = iq[w * wlen:(w + 1) * wlen]
        if len(seg) < 1024:
            break
        offs.append(estimate_carrier_offset(seg, fs, carrier_offset_hz,
                                            bw_hz))
        times.append((w + 0.5) * wlen / fs)
    offs_a = np.asarray(offs)
    times_a = np.asarray(times)
    # measured apparent freq = carrier + offset; a FAST receiver clock
    # makes carriers appear LOW: ppm = -offset/carrier * 1e6
    ppm = -offs_a / carrier_freq_hz * 1e6
    if len(ppm) >= 2:
        slope = float(np.polyfit(times_a, ppm, 1)[0])   # ppm per second
    else:
        slope = 0.0
    return {
        "ppm": float(np.mean(ppm)),
        "ppm_std": float(np.std(ppm)),
        "ppm_drift_per_hour": slope * 3600.0,
        "offset_hz": float(np.mean(offs_a)),
        "windows": [{"t": float(t), "offset_hz": float(o),
                     "ppm": float(p)}
                    for t, o, p in zip(times_a, offs_a, ppm)],
    }


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("capture", help="complex64 IQ file")
    ap.add_argument("--samp-rate", type=float, required=True)
    ap.add_argument("--center", type=float, required=True,
                    help="capture center frequency (Hz)")
    ap.add_argument("--carrier", type=float, required=True,
                    help="known reference carrier frequency (Hz)")
    ap.add_argument("--window", type=float, default=1.0)
    ap.add_argument("--bw", type=float, default=25000.0)
    ap.add_argument("--telegraf", action="store_true",
                    help="emit telegraf line protocol like "
                         "util/measure_drift_telegraf.sh")
    ap.add_argument("--device", default="rtlsdr0")
    args = ap.parse_args(argv)
    iq = np.fromfile(args.capture, np.complex64)
    r = measure_drift(iq, args.samp_rate, args.carrier - args.center,
                      args.carrier, args.window, args.bw)
    if args.telegraf:
        print(f"sdr_drift,device={args.device} "
              f"ppm={r['ppm']:.4f},offset_hz={r['offset_hz']:.2f},"
              f"drift_ppm_hr={r['ppm_drift_per_hour']:.5f}")
    else:
        print(json.dumps({k: v for k, v in r.items()}))


if __name__ == "__main__":
    main()
