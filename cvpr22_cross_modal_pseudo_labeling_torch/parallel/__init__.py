"""Data parallelism over processes (``parallel/dist.py``)."""
