"""The multi-device engines: episode-parallel dp (``engine.py``), the 2-D
dp x mp engine (``pjit_engine.py``) and the launcher (``launch.py``)."""
