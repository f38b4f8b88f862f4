"""Share of the traced window with nothing running on the device, in
cells judged on a latency (open loop below the knee)."""
from bench.readers import idle_share as read  # noqa: F401
