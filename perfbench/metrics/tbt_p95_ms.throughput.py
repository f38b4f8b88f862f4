"""95th percentile of every gap between consecutive output tokens
delivered in the window (tokens of one fused dispatch: gap 0), in cells judged on tokens per second (saturated).
A record: its runs spread too widely to bound."""
from bench.readers import tbt_p95 as read  # noqa: F401
