"""drop_p95_ms: 95th percentile over every drop of the window, decode_wav call to report written."""
from portbench.core.readers import p95_ms as read  # noqa: F401
