"""Analysis of a trained model's gating matrix."""
