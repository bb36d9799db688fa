"""Distribution layer of the port: fault-tolerance utilities. The mesh
sharding rules and elastic re-mesh come with ROADMAP queue 1 items 10c
and 11."""
