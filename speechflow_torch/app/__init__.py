"""Applications of the port: the stdlib HTTP demo server."""
