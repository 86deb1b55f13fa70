"""Sharding the capture pipelines over processes (``mesh``)."""
