"""Model FLOPs of the window's prefill plans over those plans' host time,
as a share of the bf16 peak."""
import flops
from bench.readers import prefill_flops


def read(run):
    calls = run.in_window(run.probes.prefills)
    wall = sum(c.end - c.start for c in calls)
    if not wall:
        return None
    return 100.0 * prefill_flops(run) / wall / flops.PEAK_BF16_FLOPS
