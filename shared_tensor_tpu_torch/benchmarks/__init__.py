"""Benchmarks of the port that run on the card (``pareto.py``)."""
