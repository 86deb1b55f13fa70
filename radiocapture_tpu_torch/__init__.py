"""radiocapture_tpu_torch — the PyTorch + CUDA port of radiocapture_tpu.

The capture hot path runs on PyTorch tensors with five hand-written CUDA
kernels for Hopper (``csrc/``):

- the fused channelizer bank on wire planes (``ops.channelizer_kernel.
  bank_fused``) and the fused discriminator → boxcar → fsk4 → slicer
  tracker (``demod.track_kernel``): ``ControlPipeline``;
- the float32 complex bank (``ops.channelizer_kernel.bank_complex``),
  the route of ``XlatBank.__call__`` and ``SpectrumSplit2``, and the
  fused CQPSK tracker (``demod.cqpsk_kernel``): ``CqpskControlPipeline``;
- the fused discriminator → de-emphasis → squelch power tracker
  (``ops.fm_kernel``): ``AnalogVoicePipeline``.

``runtime.SiteRuntime`` steps those pipelines, grouped by (rate, class),
on a device it is given, and turns decoded grants into recorded calls.

On CPU tensors every kernel wrapper runs its plain PyTorch reference
instead, which is what the CPU tests compare against the JAX package.

The package imports ``torch`` and never ``jax``, ``ml_dtypes`` or
``radiocapture_tpu``. Host code (``demod.framer``, ``demod.tdma``,
``demod.engines``, ``demod.provoice``, ``protocol/``, ``fec/``,
``control/``, ``audio/``, ``frontend.scheduler``, ``rxconfig``,
``utils.logconfig``) is copied from the JAX package with the package
name changed; ``audio.recorder`` differs only where it resamples.

Layout mirrors the JAX package: ``ops/``, ``demod/``, ``frontend/``,
``audio/``, ``control/``, ``testing/``, ``fec/``, ``protocol/``;
``convert`` moves streaming state between the two.
"""

__version__ = "0.1.0"
