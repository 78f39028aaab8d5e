"""Timing and profiling helpers of the port (``timing.py``, ``profiling.py``)."""
