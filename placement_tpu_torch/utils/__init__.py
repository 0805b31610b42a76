"""Config utilities of the port."""
