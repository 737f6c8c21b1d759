"""archive_rtf: audio seconds of every file of the passes run in the window over its seconds."""
from portbench.core.readers import rate as read  # noqa: F401
