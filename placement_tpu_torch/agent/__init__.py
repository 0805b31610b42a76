"""Agents of the port: the policy (acting) and the random-policy baseline."""
