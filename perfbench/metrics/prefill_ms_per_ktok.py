"""Device time of the kernels launched inside the prefill calls of the
traced window, per 1,000 prompt tokens they prefilled."""
from bench.readers import PREFILL, device_s, prefill_tokens


def read(run):
    s, n = device_s(run, PREFILL), prefill_tokens(run)
    if s is None or not n:
        return None
    return 1e3 * s / (n / 1e3)
