"""Launchers of the port: serve and train, on one device (the mesh and the
sharded launcher wait, ROADMAP A-7)."""
