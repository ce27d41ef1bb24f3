"""Servers of the port: the engine server over the stdlib transport."""
