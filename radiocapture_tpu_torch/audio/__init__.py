"""audio of the PyTorch port (see the package docstring): ``wav``,
``postproc`` and ``imbe`` are host-side copies of their
``radiocapture_tpu.audio`` namesakes with the package name changed
(``tests/test_torch_host.py``); ``recorder`` differs only in
``CallRecorder._to_8k``, which resamples with the port's ``ops.resample``."""
