"""In-memory datasets, the batch loader and the synthetic fixture."""
