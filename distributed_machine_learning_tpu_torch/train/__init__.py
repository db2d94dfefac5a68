"""Training: optimizer, state, loss, the LM step and the measured loop."""
