"""Share of the traced window with nothing running on the device, in
cells judged on tokens per second (saturated)."""
from bench.readers import idle_share as read  # noqa: F401
