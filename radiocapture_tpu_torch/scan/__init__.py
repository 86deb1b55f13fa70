"""Spectrum scan, system discovery, and conventional-scanner capture
(port of ``radiocapture_tpu.scan``; reference fft_vector.py /
fft_peak_detection.py / ov_scan.py / scanning_receiver.py)."""

from radiocapture_tpu_torch.scan.spectrum import (SpectrumScanner,
                                                  ChannelPeak, find_channels)
from radiocapture_tpu_torch.scan.discovery import (TrialResult,
                                                   trial_p25_lock,
                                                   average_offset,
                                                   band_scan_candidates)
from radiocapture_tpu_torch.scan.scanner import ScanChannel, ScanningReceiver

__all__ = ["SpectrumScanner", "ChannelPeak", "find_channels",
           "TrialResult", "trial_p25_lock", "average_offset",
           "band_scan_candidates", "ScanChannel", "ScanningReceiver"]
