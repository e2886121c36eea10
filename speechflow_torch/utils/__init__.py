"""Small helpers shared by the port: masks and device selection."""
