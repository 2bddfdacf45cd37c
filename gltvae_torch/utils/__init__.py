"""Keras .h5 interchange with the reference and torch.export serving
artifacts."""
