"""Median of every gap between consecutive output tokens delivered in the
window (tokens of one fused dispatch: gap 0): the wait for a token that
most of the streamed tokens saw.  Below the knee most gaps are decode
steps, each with the mirrors of the requests in flight, so it moves with
decode, the mirrors and the host's work a step; the steps that carry a
prefill and its stream (about a tenth of the gaps) show in the tails,
which are records."""
from bench.readers import tbt_p50 as read  # noqa: F401
