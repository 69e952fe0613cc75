"""Train state, optimizer and schedules, and the training step."""
