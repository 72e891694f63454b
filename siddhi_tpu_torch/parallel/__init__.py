"""Partitioned execution (PyTorch port of siddhi_tpu/parallel/): the
key-slot partition blocks of parallel/partition.py. The reference's
device meshes (sharding.py, mesh.py) are not ported yet."""
