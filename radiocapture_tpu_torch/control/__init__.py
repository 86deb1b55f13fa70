"""control of the PyTorch port (see the package docstring): host-side
copies of the ``radiocapture_tpu.control`` modules the runtime uses, with
the package name changed (``tests/test_torch_host.py``)."""
