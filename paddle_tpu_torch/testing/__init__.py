"""Test support shared by the CPU tests and ``chip_smoke.py``: the op
surface's case table (``op_cases``)."""
