"""Multi-device parallelism: meshes, sharded indices, cross-shard merge."""
