"""Command-line tools of the port: the counterparts of the JAX package's
`tools/` and of its root scripts (`benchmark`, `run_tests`,
`manual_control`: `python -m minigrid_tpu_torch.tools.<name>`)."""
