"""Networks and the CCVAE model with its losses."""
