"""Bytes the cluster mirrored and streamed between instances in the
window, per output token delivered in it."""


def read(run):
    tokens = run.output_tokens()
    if not tokens:
        return None
    return (run.delta("mirror_bytes") + run.delta("stream_bytes")) / tokens
