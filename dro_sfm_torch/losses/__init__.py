"""Training losses: the supervised depth + pose loss and its helpers."""
