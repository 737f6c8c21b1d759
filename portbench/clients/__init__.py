"""Clients: one per entry point of the port that a traffic mix can drive."""
