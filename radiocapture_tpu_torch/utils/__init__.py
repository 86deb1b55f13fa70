"""utils of the PyTorch port: ``logconfig`` is a copy of its
``radiocapture_tpu.utils`` namesake with the package name changed
(``tests/test_torch_host.py``)."""
