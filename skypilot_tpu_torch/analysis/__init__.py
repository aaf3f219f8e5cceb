"""Runtime checks of the port (the twin of ``skypilot_tpu/analysis``)."""
