"""The prefill attention kernel's share of its roofline: the bound of
the attention the window's prefill plans need over the device time of
the kernels launched inside the kernel entry."""
from bench.readers import FLASH, device_s, flash_bound_s, share


def read(run):
    return share(flash_bound_s(run), device_s(run, FLASH))
