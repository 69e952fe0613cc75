"""Small helpers shared by the entry points."""
