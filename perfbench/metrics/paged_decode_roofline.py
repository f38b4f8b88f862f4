"""The paged decode attention kernel's share of its roofline: the
bound of the attention the window's decode steps need over the device
time of the kernels launched inside the kernel entry."""
from bench.readers import PAGED, device_s, paged_bound_s, share


def read(run):
    return share(paged_bound_s(run), device_s(run, PAGED))
