"""Agents of the port: the policy, the PPO learner and trainer, and the
random-policy baseline."""
