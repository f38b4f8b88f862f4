"""Host time of each decode plan of the window (it ends in the engine's
own host sync), averaged, in cells judged on a latency (open loop below the knee)."""
from bench.readers import decode_step_ms as read  # noqa: F401
