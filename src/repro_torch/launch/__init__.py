"""Launch entry points of the LM substrate: step functions (``steps``), the
training driver (``train``, also ``python -m repro_torch.launch.train``) and
the serving engine (``serve``, also ``python -m repro_torch.launch.serve``)."""
