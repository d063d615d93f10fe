"""Launchers of the port: serve (train and the mesh wait, ROADMAP A-9)."""
