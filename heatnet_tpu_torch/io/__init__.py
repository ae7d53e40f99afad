"""JAX parameter trees → the port's ``state_dict``; checkpoints; run logs."""
