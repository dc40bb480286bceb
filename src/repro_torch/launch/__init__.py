"""Command-line entry points of the port: ``python -m repro_torch.launch.serve``
serves tape traces on one library or a federation (see :mod:`.serve`), and
``python -m repro_torch.launch.train`` trains a language model on one device
(see :mod:`.train`)."""
