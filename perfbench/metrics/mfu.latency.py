"""The whole step's share of the bf16 peak in a cell judged on its
latencies: model FLOPs of every plan of the window over its seconds
(``bench.readers.window_mfu``), beside the kernels' rooflines."""
from bench.readers import window_mfu as read  # noqa: F401
