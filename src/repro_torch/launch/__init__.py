"""Launchers of the port: serve and train (sharded on a mesh when started
under ``torchrun``), the meshes and sharding rules, and the dry-run tools
(``dispatch_cost``, ``roofline``, ``dryrun``, ``hillclimb``)."""
