"""Camera, pose and rotation helpers."""
