"""Launch layer: the training driver (``python -m repro_torch.launch.train``).

The reference's mesh, sharding and dry-run helpers are not ported (the
port runs on one device), so nothing is exported here; the driver is
imported from its module.
"""
