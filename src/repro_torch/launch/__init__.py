"""Launch entry points of the LM substrate: step functions (``steps``) and the
serving engine (``serve``, also ``python -m repro_torch.launch.serve``)."""
