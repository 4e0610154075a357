"""Runnable examples, twins of the reference's ``examples/``:

  python -m repro_torch.examples.quickstart [--device cpu]
  python -m repro_torch.examples.async_fedbuff [--device cpu]
  python -m repro_torch.examples.million_client_selection [--device cpu]

Each runs on the CUDA card unless ``--device cpu`` is given."""
