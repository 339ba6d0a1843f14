"""Dataset converters of the port (numpy on the host)."""
