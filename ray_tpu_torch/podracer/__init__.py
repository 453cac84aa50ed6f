"""The podracer members' compute in torch (``podracer/runtime.py``)."""
