"""The whole step's share of the bf16 peak in a cell judged on its
tokens per second (``bench.readers.window_mfu``)."""
from bench.readers import window_mfu as read  # noqa: F401
