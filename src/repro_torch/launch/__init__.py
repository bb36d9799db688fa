"""Launchers of the port: serving (``python -m repro_torch.launch.serve``),
training (``launch.train``), the meshes (``launch.mesh``), the dry-run cells
(``launch.specs``), the dry-run itself (``launch.dryrun``) and its cost
analysis (``launch.hlo_analysis``)."""
