"""Serve's one JAX touchpoint, ported (``serve/proxy.py:_jsonable``)."""
