"""Output tokens delivered in the window over its seconds."""
from bench.stats import rate


def read(run):
    return rate(run.output_tokens(), run.seconds)
