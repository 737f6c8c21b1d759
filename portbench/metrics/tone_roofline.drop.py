"""tone_roofline: percent of the tone kernels' roofline (core/work.py counts the
work from the inputs).  tone_ratios_kernel is both the ratios (monolithic, batch)
and the raw powers (segmented) of ops/kernels/tone_ratios.cu."""
from portbench.core.readers import roofline
from portbench.core.work import tone_least_seconds

KERNELS = ("tone_ratios_kernel",)


def read(reading):
    return roofline(reading, tone_least_seconds, KERNELS)
