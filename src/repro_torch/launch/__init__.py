"""Launch layer: meshes (``mesh``), sharding rules (``sharding``), the
training step and the (architecture x shape) cells (``steps``), the
meta-device dry run (``python -m repro_torch.launch.dryrun``) and the
training CLI (``python -m repro_torch.launch.train``)."""
