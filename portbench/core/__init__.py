"""The harness core: nothing in it belongs to one cell."""
