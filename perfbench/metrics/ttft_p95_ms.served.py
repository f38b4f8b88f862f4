"""95th percentile of the time to first token over every request due in
the window, a request still waiting at its end counted with its wait.  A
record, not a judged tail: its runs spread too widely to bound."""
from bench.readers import ttft_p95 as read  # noqa: F401
