"""The benchmark's frozen harness: traffic in seconds, the wall-clock pump
over the port's cluster, the reduction of spans, counters and the device
trace to metrics, and the comparison that decides ``correct``."""
