"""Change of LiveCluster's scheduling time (policy and planner) over
the window, per scheduling iteration, in cells judged on tokens per second (saturated)."""
from bench.readers import sched_us_per_iter as read  # noqa: F401
