"""Model construction, optimizer and the fused training step."""
