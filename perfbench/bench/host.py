"""What the host did around a run's window, for the run's info line: the
CPU's name, the threads and cores the process had, the machine's load, how
its CPU time split over the window (``steal`` is time a virtual machine's
cores waited for the host), the CPU time of the process and of its main
thread against the wall, and the interpreter's speed on a fixed loop just
before and just after the window.  A run that reads slow can so be told
from a host that ran slow.  Nothing here feeds a metric."""
from __future__ import annotations

import os
import time

#: fields of /proc/stat's ``cpu`` line, in order
_FIELDS = ("user", "nice", "system", "idle", "iowait", "irq", "softirq",
           "steal")


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return "unknown"


def _stat() -> list:
    try:
        with open("/proc/stat") as f:
            return [int(x) for x in f.readline().split()[1:9]]
    except (OSError, ValueError):
        return [0] * len(_FIELDS)


def _loadavg() -> float:
    try:
        return os.getloadavg()[0]
    except OSError:
        return -1.0


def loop_ms(n: int = 1_000_000) -> float:
    """Milliseconds the interpreter takes for ``n`` additions."""
    t = time.perf_counter()
    s = 0
    for i in range(n):
        s += i
    return 1e3 * (time.perf_counter() - t)


class Host:
    def __init__(self):
        self.info = {"cpu": _cpu_model(), "cpus": os.cpu_count(),
                     "affinity": len(os.sched_getaffinity(0))}

    def open(self) -> None:
        self.info["loop_ms_before"] = loop_ms()
        self.info["load_before"] = _loadavg()
        self._stat = _stat()
        self._t = (time.perf_counter(), time.process_time(),
                   time.thread_time())

    def close(self) -> None:
        wall = time.perf_counter() - self._t[0]
        d = [b - a for a, b in zip(self._stat, _stat())]
        total = sum(d) or 1
        self.info["cpu_share"] = {k: v / total for k, v in zip(_FIELDS, d)}
        self.info["process_cpu_per_wall"] = (
            (time.process_time() - self._t[1]) / wall)
        self.info["main_thread_cpu_per_wall"] = (
            (time.thread_time() - self._t[2]) / wall)
        self.info["load_after"] = _loadavg()
        self.info["loop_ms_after"] = loop_ms()

    def summary(self, threads: int) -> dict:
        return dict(self.info, torch_threads=threads)
