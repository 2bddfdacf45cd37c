"""Data parallelism over ``torch.distributed`` (counterpart of
gltvae/parallel): ``mesh`` (the process group a rank belongs to), ``dp``
(the DP step's semantics, shard/place helpers) and ``shardmap`` (the
explicit variant with per-rank noise)."""
