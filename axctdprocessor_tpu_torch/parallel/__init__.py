"""Multi-drop paths of the port: ``batch`` (a (B, N) batch on one device)."""
