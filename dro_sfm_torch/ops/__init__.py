"""Compute ops: resampling, resize, convex upsampling, the warp-cost kernel."""
