"""Launch layer: the training step (``steps``) and the training CLI
(``python -m repro_torch.launch.train``)."""
