"""Host time of the window's cluster steps over their count, in
cells judged on tokens per second (saturated)."""
from bench.readers import iter_ms as read  # noqa: F401
