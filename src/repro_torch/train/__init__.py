"""Training: AdamW, checkpoints, the fault-tolerant loop and elastic hooks."""
