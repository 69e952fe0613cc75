"""DepthPoseNet and its encoder and update blocks."""
