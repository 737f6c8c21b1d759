"""host_launches: the host's launch calls per traced unit (kernel and graph
launches, copies, fills), from the profiler."""
from portbench.core.readers import launches_per_unit as read  # noqa: F401
