"""CLI time-string parsing: ``SS``, ``MM:SS`` or ``HH:MM:SS`` -> seconds.

A copy of axctdprocessor_tpu.utils.timeparse, whole: the port imports
nothing of the JAX package.

Behavioral contract from the reference CLI (processAXCTD.py:106-121):
colon-separated fields accumulate as value * 60^i from the right, fields
beyond the hours place are ignored with a warning, and an unparseable
string yields the sentinel ``-2`` (which then flows through the range
logic unchanged — see utils.config for how strict-compat mode preserves
that quirk).
"""

from __future__ import annotations

import logging

logger = logging.getLogger(__name__)

UNPARSEABLE = -2


def parse_time_string(time_string: str) -> int:
    try:
        if ":" in time_string:
            total = 0
            for i, field in enumerate(reversed(time_string.split(":"))):
                if i <= 2:
                    total += int(field) * 60**i
                else:
                    logger.info(
                        "ignoring time fields past the hours place (HH:MM:SS)"
                    )
            return total
        return int(time_string)
    except ValueError:
        logger.info("unable to interpret time %r; using sentinel", time_string)
        return UNPARSEABLE
