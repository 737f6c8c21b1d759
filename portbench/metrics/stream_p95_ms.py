"""stream_p95_ms: 95th percentile over every block of the window, feed to
latest_rows (a drop's last block: to finalize)."""
from portbench.core.readers import p95_ms as read  # noqa: F401
