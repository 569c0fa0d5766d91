"""Runtime of the port (port of `repro.runtime`): the fault-tolerant
training loop and straggler detection, the sharding rules, GPipe pipeline
parallelism and elastic re-meshing."""
