"""Median time to first token over every request due in the window: from
the wall time it was due to the end of the step that delivered its first
token, a request still waiting at the window's end counted with its wait
so far.  Below the knee a request waits for little but its own prefill
and stream, so this moves with the prefill path (GEMMs, flash, the
stream to the partner)."""
from bench.readers import ttft_p50 as read  # noqa: F401
