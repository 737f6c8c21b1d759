"""idle_share: percent of the traced window in which the card ran nothing."""
from portbench.core.readers import idle_share as read  # noqa: F401
