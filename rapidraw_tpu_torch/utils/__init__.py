"""Host utilities of the port (settings)."""
