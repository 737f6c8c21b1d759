"""Package data of the port: the temperature lookup table (``temp_LUT.txt``).

A copy of axctdprocessor_tpu/data/temp_LUT.txt, read by ``utils.lut``."""
