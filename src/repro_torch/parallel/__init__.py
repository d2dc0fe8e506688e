"""Mesh placement of the port: the sharding rules and the activation hints
(port of ``repro.parallel``)."""
