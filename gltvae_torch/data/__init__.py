"""Datasets (in memory, CelebA files, decoded caches), the batch loader,
the native decode pool and the synthetic fixture."""
