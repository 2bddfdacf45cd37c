"""Analysis of a trained model's gating matrix and the latent traversal."""
