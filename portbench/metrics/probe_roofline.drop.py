"""probe_roofline.drop: percent of the per-bit probe kernel's roofline
(ops/kernels/probe.cu; core/work.py counts the work from the inputs)."""
from portbench.core.readers import roofline
from portbench.core.work import probe_least_seconds

KERNELS = ("probe_run_kernel",)


def read(reading):
    return roofline(reading, probe_least_seconds, KERNELS)
