"""90th percentile of every gap between consecutive output tokens
delivered in the window (tokens of one fused dispatch: gap 0).  A record:
the gaps of the steps that carry a prefill and its stream are a tenth or
so of the cell's gaps, so this percentile sits between those steps and
the decode steps and swings from run to run."""
from bench.readers import tbt_p90 as read  # noqa: F401
