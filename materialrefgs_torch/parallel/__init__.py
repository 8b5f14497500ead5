"""Scale-out of the port over torch.distributed: camera-batch data
parallelism (data_parallel.py, dp_trainer.py), tile-sharded rasterization of
one view (tile_sharding.py) and process-group set-up across hosts
(multihost.py)."""
