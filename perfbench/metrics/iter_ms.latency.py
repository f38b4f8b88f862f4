"""Host time of the window's cluster steps over their count, in
cells judged on a latency (open loop below the knee)."""
from bench.readers import iter_ms as read  # noqa: F401
