"""Static passes and runtime checks of the port (the twin of
``skypilot_tpu/analysis``): the skycheck passes that
``scripts/skycheck_torch.py`` drives, and the env-gated sanitizers."""
