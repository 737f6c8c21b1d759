"""drop_rtf: audio seconds of the drops completed in the window over its seconds."""
from portbench.core.readers import rate as read  # noqa: F401
