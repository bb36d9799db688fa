"""Distribution layer of the port: the mesh sharding rules and per-rank
collectives (``sharding``), fault-tolerance utilities (``fault``) and
elastic moves of live state between devices and meshes (``elastic``)."""
