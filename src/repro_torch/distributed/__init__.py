"""Distribution layer of the port: fault-tolerance utilities and elastic
moves of live state between devices. The mesh sharding rules come with
ROADMAP queue 1 item 11."""
