"""Point clouds and trajectories of the inference applications (numpy)."""
