"""Agents of the port: the random-policy baseline."""
