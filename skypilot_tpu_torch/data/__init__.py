"""Data loading of the port: token files and seeded, sharded batches
(``data.loader``, a copy of ``skypilot_tpu/data/loader.py``)."""
